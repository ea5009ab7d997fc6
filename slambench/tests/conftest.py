import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """The CUDA card, decided when a test asks for it; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def pytest_configure(config):
    """Few threads per process: the test workers share the machine's
    cores, and each CPU rehearsal runs the port's loop."""
    import torch

    torch.set_num_threads(2)
