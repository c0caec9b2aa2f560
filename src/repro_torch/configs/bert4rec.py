"""BERT4Rec [arXiv:1904.06690]: bidirectional sequential recommendation."""
from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="bert4rec", kind="bert4rec", embed_dim=64, n_blocks=2, n_heads=2,
    seq_len=200, n_items=1_000_000, mlp_dims=(),
    rcllm_enabled=True)  # item-embedding reuse maps to the item-KV pool
