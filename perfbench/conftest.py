"""The benchmark's CPU tests: the card is never needed here; tests that
would need it are marked ``gpu`` and decide inside a fixture."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped where none is present")


@pytest.fixture(autouse=True)
def _fresh_inproc_services():
    """Each test gets an empty in-process courier registry."""
    from repro_torch.core.courier import inprocess
    inprocess.reset()
    yield
    inprocess.reset()
