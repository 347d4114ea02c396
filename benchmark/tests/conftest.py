"""The benchmark's tests. `card` marks a test that needs an NVIDIA card;
here, with none, it skips. On the card:

    python -m pytest benchmark/tests -m card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips where there is none)")


@pytest.fixture(autouse=True)
def _card(request):
    if request.node.get_closest_marker("card") is not None:
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA card; none is visible")
