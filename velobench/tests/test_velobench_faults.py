"""The comparison sees a broken timed path: each fault the cells can have,
planted under a run on the CPU, turns ``correct`` false.  (Neither cell
trains, and both run on one card, so a state left unchanged and a missing
exchange between chips are not theirs.)"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import velobench_tiny as tiny  # noqa: E402

from repro_torch.core import baselines, distance, search  # noqa: E402
from repro_torch.velo import scan_search as scan_mod  # noqa: E402


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("velobench_cache")


def _wrong(result, number):
    assert result["correct"] is False
    if number != "id_mismatch":  # a share of a sample, not a verdict on each answer
        assert result["failed"] > 0
    assert result["checks"][number]["value"] > result["checks"][number]["limit"]


def test_engine_half_the_batch_left_out(monkeypatch, cache_dir):
    run = baselines.System.run

    def half(self, queries, *a, **kw):
        results, stats = run(self, queries[: len(queries) // 2], *a, **kw)
        return results, stats

    monkeypatch.setattr(baselines.System, "run", half)
    _wrong(tiny.run(tiny.ENGINE, cache_dir)[0], "bad_answers")


def test_engine_answer_altered_where_produced(monkeypatch, cache_dir):
    finish = search._finish

    def altered(refined, k):
        ids, ds = finish(refined, k)
        ids = ids.copy()
        ids[-1] = next(v for v in range(10**6) if v not in set(ids.tolist()))
        return ids, ds

    monkeypatch.setattr(search, "_finish", altered)
    _wrong(tiny.run(tiny.ENGINE, cache_dir)[0], "dist_gap")


def test_engine_estimate_altered_where_produced(monkeypatch, cache_dir):
    estimate = distance.DistanceEngine.estimate

    def altered(self, *a, **kw):
        return estimate(self, *a, **kw) * np.float32(1.001)

    monkeypatch.setattr(distance.DistanceEngine, "estimate", altered)
    result = tiny.run(tiny.ENGINE, cache_dir)[0]
    _wrong(result, "est_gap")
    assert result["checks"]["dist_gap"]["value"] <= result["checks"]["dist_gap"]["limit"]


def test_scan_half_the_batch_left_out(monkeypatch, cache_dir):
    scan = scan_mod.scan_search

    def half(index, queries, *a, **kw):
        h = len(queries) // 2
        ids, d2 = scan(index, queries[:h], *a, **kw)
        return torch.cat([ids, ids[: len(queries) - h]]), torch.cat([d2, d2[: len(queries) - h]])

    monkeypatch.setattr(scan_mod, "scan_search", half)
    result = tiny.run(tiny.SCAN, cache_dir)[0]
    _wrong(result, "dist_gap")
    _wrong(result, "id_mismatch")


def test_scan_answer_altered_where_produced(monkeypatch, cache_dir):
    scan = scan_mod.scan_search

    def altered(*a, **kw):
        ids, d2 = scan(*a, **kw)
        return ids, d2 * (1 + 1e-3 * (torch.arange(d2.shape[1]) == 9))

    monkeypatch.setattr(scan_mod, "scan_search", altered)
    _wrong(tiny.run(tiny.SCAN, cache_dir)[0], "dist_gap")


def test_scan_stage1_chunks_left_out(monkeypatch, cache_dir):
    block = scan_mod.stage1_block
    calls = []

    def skipping(*a, **kw):
        est = block(*a, **kw)
        calls.append(1)
        return est if len(calls) % 2 else torch.full_like(est, 3e38)

    monkeypatch.setattr(scan_mod, "stage1_block", skipping)
    result = tiny.run(tiny.SCAN, cache_dir)[0]
    _wrong(result, "id_mismatch")
    assert np.isclose(result["checks"]["bad_answers"]["value"], 0)
