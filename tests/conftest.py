import os

# Tests run on the single real CPU device; ONLY the dry-run tests use
# placeholder devices, and those shard over whatever exists (they never
# assume 512). Keep jax quiet and deterministic.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest


@pytest.fixture(autouse=True)
def _reset_inproc_registry():
    """Each test gets a clean in-process courier registry."""
    from repro.core.courier import inprocess
    inprocess.reset()
    yield
    inprocess.reset()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped where none is present")
