import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread(monkeypatch, tmp_path):
    """One torch thread (several workers share the machine, and the CPU
    GEMM is reproducible run to run only on one) and a fresh artifact
    cache for the policy executor."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "artifacts"))
    yield
    torch.set_num_threads(n)
