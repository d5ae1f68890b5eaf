"""Pytest settings of the benchmark's own tests (zkbench/tests).

`card` marks a test that needs an NVIDIA card; the `card` fixture skips
it, deciding when the test runs, never at import, where there is none.
The whole run on the card: `python -m pytest zkbench/tests -m card`."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
