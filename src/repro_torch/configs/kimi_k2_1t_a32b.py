"""Kimi K2 1T-A32B [arXiv:2501.kimi2, paper-table]: 61L MoE 384e top-8.

The reference also names its training optimizer (Adafactor); the port's
config carries the serving fields only.  At 2.1 TB of bf16 weights it
runs on one card only at `reduced()` size.
"""
from repro_torch.configs.base import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab_size=163840, mlp_type="swiglu",
    moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048, capacity_factor=1.25),
    rope_theta=50_000.0)
