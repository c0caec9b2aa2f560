"""DIEN [arXiv:1809.03672]: interest evolution w/ GRU + AUGRU."""
from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="dien", kind="dien", embed_dim=18, seq_len=100, gru_dim=108,
    mlp_dims=(200, 80), n_items=1_000_000, n_cates=10_000,
    rcllm_enabled=True)  # sharded-embedding store + affinity routing analogue
