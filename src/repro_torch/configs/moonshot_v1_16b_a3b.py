"""Moonlight/moonshot-v1 16B-A3B [hf:moonshotai/Moonlight-16B-A3B]: MoE 64e top-6."""
from repro_torch.configs.base import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=163840, mlp_type="swiglu",
    moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408, capacity_factor=1.25),
    rope_theta=50_000.0)
