"""Wide&Deep [arXiv:1606.07792]: 40 sparse fields, concat interaction."""
from repro_torch.configs.base import RecsysConfig

# Heavy-tailed per-field vocabularies (Criteo-style): a few huge ID spaces,
# many small categorical fields. Total ~9.1M embedding rows.
_VOCABS = tuple([1_000_000] * 8 + [100_000] * 8 + [10_000] * 12 + [1_000] * 12)

CONFIG = RecsysConfig(
    name="wide-deep", kind="wide_deep", embed_dim=32, n_dense=13,
    field_vocabs=_VOCABS, mlp_dims=(1024, 512, 256), rcllm_enabled=True)
