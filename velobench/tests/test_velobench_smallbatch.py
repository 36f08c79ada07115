"""``veloann-scan.b8`` on the CPU at a small size, its batch of 8 kept: the
run is correct and reports the ``.smallbatch`` class; the control and the
faults that the cell can have (half of each batch left out, an answer
altered where it is produced) come out not correct under its limits."""

import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import velobench_tiny as tiny  # noqa: E402

from repro_torch.velo import scan_search as scan_mod  # noqa: E402
from velobench import harness, judge, registry  # noqa: E402

B8 = "veloann-scan.b8"


def run(*, control: bool = False, seed: int = tiny.SEED, seconds: float = 0.3):
    c = registry.cell(B8)
    cfg = registry.config(c["config"])
    cfg.update(n=5000, d=32, chunk=1024)
    c["traffic"].update(pool=300, sample=60)
    assert c["traffic"]["batch"] == 8
    return harness.run_cell(B8, seed, seconds, False, "cpu", time.perf_counter(), cell=c,
                            cfg=cfg, control=control, log=lambda msg: None)[0]


def test_b8_end_to_end():
    result = run()
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0 and result["attempted"] % 8 == 0
    metrics = result["metrics"]
    assert set(metrics) == {"qps.smallbatch", "p95_ms.smallbatch", "recall_at_10.smallbatch",
                            "setup_s"}
    assert metrics["qps.smallbatch"]["value"] > 0
    assert 0 < metrics["recall_at_10.smallbatch"]["value"] <= 1


def test_b8_control_is_not_correct():
    result = run(control=True)
    limits = registry.cell(B8)["limits"]
    assert judge.verdict(result["numbers"], limits)[0] is True
    ok, checks = judge.verdict(result["control"], limits)
    assert ok is False
    assert checks["dist_gap"]["value"] > 10 * limits["dist_gap"]


def _wrong(result, number):
    assert result["correct"] is False
    assert result["checks"][number]["value"] > result["checks"][number]["limit"]


def test_b8_half_the_batch_left_out(monkeypatch):
    scan = scan_mod.scan_search

    def half(index, queries, *a, **kw):
        h = len(queries) // 2
        ids, d2 = scan(index, queries[:h], *a, **kw)
        return torch.cat([ids, ids[: len(queries) - h]]), torch.cat([d2, d2[: len(queries) - h]])

    monkeypatch.setattr(scan_mod, "scan_search", half)
    result = run()
    _wrong(result, "dist_gap")
    _wrong(result, "id_mismatch")
    assert result["failed"] > 0


@pytest.mark.parametrize("row", [0, 7])
def test_b8_answer_altered_where_produced(monkeypatch, row):
    scan = scan_mod.scan_search

    def altered(*a, **kw):
        ids, d2 = scan(*a, **kw)
        return ids, d2 * (1 + 1e-3 * (torch.arange(d2.shape[0]) == row)[:, None])

    monkeypatch.setattr(scan_mod, "scan_search", altered)
    result = run()
    _wrong(result, "dist_gap")
    assert result["failed"] == result["attempted"] // 8
