"""The card fixture of the benchmark's tests."""
import pytest


@pytest.fixture
def cuda_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")
