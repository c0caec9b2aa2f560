"""StarCoder2-15B [arXiv:2402.19173]: GQA kv=4, RoPE (sliding window 4096)."""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="starcoder2-15b",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
    d_ff=24576, vocab_size=49152, mlp_type="gelu", rope_theta=100_000.0,
    sliding_window=4096)
