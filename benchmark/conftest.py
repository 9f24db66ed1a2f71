"""pytest settings of the benchmark's own tests (`benchmark/tests/`).

`card` marks a test that needs a CUDA card; it decides inside the `card`
fixture whether one is present, never while a module is imported, and
skips with a reason where there is none. On the card:
`python -m pytest benchmark/tests -m card`.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
