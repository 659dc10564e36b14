import os

# Tests run on the single real CPU device. (The 512-device override is
# reserved for launch/dryrun.py — do NOT set it here.)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skips without one (the CUDA "
        "kernels have no CPU mode)")
