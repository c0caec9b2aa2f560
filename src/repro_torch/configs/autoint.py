"""AutoInt [arXiv:1810.11921]: self-attention feature interaction."""
from repro_torch.configs.base import RecsysConfig

_VOCABS = tuple([1_000_000] * 8 + [100_000] * 8 + [10_000] * 12 + [1_000] * 11)

CONFIG = RecsysConfig(
    name="autoint", kind="autoint", embed_dim=16, n_dense=13,
    field_vocabs=_VOCABS, n_attn_layers=3, n_heads=2, d_attn=32,
    mlp_dims=(), rcllm_enabled=True)
