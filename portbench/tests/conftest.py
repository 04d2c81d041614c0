"""The benchmark's tests: on the CPU at test widths, except those marked
`card`, which run on the card (`python3 -m pytest portbench/tests -m card`
on a machine with one) and skip elsewhere."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The card; the test skips when there is none (decided here, when the
    test runs, never while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
