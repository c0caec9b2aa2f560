"""Nemotron-4-15B [arXiv:2402.16819]: GQA, squared-ReLU MLP."""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="nemotron-4-15b",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=256000, mlp_type="relu2", rope_theta=10_000.0)
