"""CPU tests of the benchmark.  Tests that need a CUDA card carry the
``chip`` marker and skip here; they run on the card with
``python -m pytest vinsbench/tests -m chip``."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the reader reads a device trace")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
