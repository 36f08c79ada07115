"""Both drivers through the port's CUDA kernels at small sizes, traced:
``correct`` true, and the trace read into busy time and per-layer numbers.
Runs on a card only."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import velobench_tiny as tiny  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("name", [tiny.ENGINE, tiny.SCAN])
def test_driver_on_the_card(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    result, _ = tiny.run(name, tmp_path, device="cuda", trace=True, seconds=1.0)
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert any(m.startswith("device.idle_share") for m in result["metrics"])
    assert result["breakdown"]["device_ops"]
