"""Test configuration: force an 8-device virtual CPU platform so sharding
paths can be exercised without an accelerator (SURVEY.md §4d)."""

import os

# Must be set before the jax backend initializes.  The suite runs on the
# CPU; ``JAX_PLATFORMS=cuda python -m pytest -m gpu`` runs the tests that
# need the card.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def small_dataset(rng):
    """A clustered synthetic dataset: vectors drawn around 32 centers so
    PQ codes repeat (gives the DeltaTree something to compress)."""
    n, d, ncl = 2000, 32, 32
    centers = rng.normal(size=(ncl, d)).astype(np.float32) * 5
    assign = rng.integers(0, ncl, size=n)
    x = centers[assign] + rng.normal(size=(n, d)).astype(np.float32) * 0.3
    return x.astype(np.float32)


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU (decided when the test runs, never at
    import, so every test worker collects the same tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu` on a machine with a card")
