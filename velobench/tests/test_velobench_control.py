"""The control fails: the reference put in the port's place and computed in
the precision below the one each configuration states (the scan's
estimator over int8 queries, the engine's estimates with the sign product
in TF32, every refined distance in bf16) comes out not
correct under each cell's limits, while the port's own answers pass."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import velobench_tiny as tiny  # noqa: E402

from velobench import judge, registry  # noqa: E402


@pytest.mark.parametrize("name", [tiny.ENGINE, tiny.SCAN])
def test_control_is_not_correct(name, tmp_path):
    result, _ = tiny.run(name, tmp_path, control=True)
    limits = registry.cell(name)["limits"]
    assert judge.verdict(result["numbers"], limits)[0] is True
    ok, checks = judge.verdict(result["control"], limits)
    assert ok is False
    assert checks["dist_gap"]["value"] > 10 * limits["dist_gap"]
    if "est_gap" in limits:
        assert checks["est_gap"]["value"] > 10 * limits["est_gap"]
