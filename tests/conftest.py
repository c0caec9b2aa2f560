import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (tier-1 CI runs -m 'not slow'; the full "
        "suite still covers these)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (a CUDA kernel has no CPU mode); skips "
        "itself where torch.cuda.is_available() is false")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
