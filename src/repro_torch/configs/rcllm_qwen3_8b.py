"""Qwen3-8B-like config: the paper's primary accuracy/serving model [arXiv:2505.09388]."""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="rcllm-qwen3-8b",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, vocab_size=151936, mlp_type="swiglu", rope_theta=1_000_000.0)
