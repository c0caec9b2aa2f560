"""SchNet [arXiv:1706.08566]: continuous-filter convolutions."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="schnet", n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0)
