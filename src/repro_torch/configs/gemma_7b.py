"""Gemma-7B [arXiv:2403.08295]: GeGLU, head_dim=256, 16 KV heads (MHA)."""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="gemma-7b",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000, mlp_type="geglu", rope_theta=10_000.0,
    tie_embeddings=True)
