"""``tools/engine_spans.py`` on the CPU: the merged timeline labels an idle
gap by the innermost port span and falls back to the harness's label outside
them; the readings come from the port's totals and the counters, and leave
out what a run lacks; the engine cell's counters gain the pool's evictions and
the distance plane's copies in a small engine run; and the tool's own run,
with the profiler off, puts the whole window under the port's spans."""

import importlib.util
import json
import sys
from array import array
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT), str(ROOT / "src"), str(ROOT / "velobench" / "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import velobench_tiny as tiny  # noqa: E402

from repro_torch import tracing  # noqa: E402
from velobench import index_cache, registry, trace  # noqa: E402
from velobench.spans import Spans  # noqa: E402

_spec = importlib.util.spec_from_file_location("engine_spans", ROOT / "tools" / "engine_spans.py")
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)

MS = 1_000_000  # ns


def _port_timeline():
    """engine.run [10, 90] holding search.step [20, 40] (store.decode [25,
    30] inside it) and distance.execute [50, 80] (distance.d2h [60, 70])."""
    names = ("engine.run", "search.step", "store.decode", "distance.execute", "distance.d2h")
    ids = {n: tracing.name(n) for n in names}
    spans = [("engine.run", 10, 90, -1), ("search.step", 20, 40, 0),
             ("store.decode", 25, 30, 1), ("distance.execute", 50, 80, 0),
             ("distance.d2h", 60, 70, 3)]
    t0, t1, parent = (array("q", [s[k] for s in spans]) for k in (1, 2, 3))
    rec = tracing.Recording(tuple(tracing.NAMES), array("q", [ids[s[0]] for s in spans]),
                            t0, t1, parent, array("q", [0] * 5), array("q", [-1] * 5), {})
    return rec.timeline()


def test_idle_gaps_take_the_innermost_port_span():
    harness = Spans()
    harness.record = True
    harness.events += [("engine", 5, 95, 0), ("distance.estimate_many", 52, 78, 1)]
    merged = tool.relabel(harness.timeline(), *_port_timeline())
    assert [t for t, _ in merged] == sorted(t for t, _ in merged)
    # the device busy over [0, 2] and [97, 99]: the window [0, 100]
    s = trace.summarize([("k", 0, 2), ("k", 97, 2)], merged, 0, 100)
    want = {"harness": 3 + 2 + 1, "engine": 5 + 5, "engine.run": 10 + 10 + 10,
            "search.step": 15, "store.decode": 5, "distance.execute": 20, "distance.d2h": 10}
    assert s["idle_s"] == pytest.approx({k: v * 1e-9 for k, v in want.items()})
    # outside every port span the harness's labels stand, as without them
    plain = trace.summarize([("k", 0, 2), ("k", 97, 2)], harness.timeline(), 0, 100)
    assert plain["idle_s"] == pytest.approx(
        {"harness": 6e-9, "engine": 64e-9, "distance.estimate_many": 26e-9})
    assert sum(plain["idle_s"].values()) == pytest.approx(sum(s["idle_s"].values()))


def test_readings_from_the_totals_and_counters():
    port = {"engine.run": (2, 40 * MS, 4 * MS), "search.step": (30, 20 * MS, 20 * MS),
            "store.decode": (8, 2 * MS, 2 * MS), "pool.admit": (8, 1 * MS, 1 * MS),
            "distance.execute": (6, 10 * MS, 3 * MS), "distance.h2d": (12, 2 * MS, 2 * MS),
            "distance.d2h": (6, 5 * MS, 5 * MS), "kernels.launch": (6, 3 * MS, 3 * MS)}
    counters = {"pool.evictions": 6, "distance.h2d_copies": 12, "distance.d2h_copies": 6,
                "distance.level1_calls": 4, "distance.level2_calls": 2}
    got = tool.readings(port, counters, 2)
    assert got == pytest.approx({
        "engine.sched_ms_per_query": 2.0, "search.step_ms_per_query": 10.0,
        "store.decode_ms_per_query": 1.0, "pool.admit_ms_per_query": 0.5,
        "distance.prep_ms_per_query": 1.5, "distance.h2d_ms_per_query": 1.0,
        "distance.d2h_ms_per_query": 2.5, "kernels.wrapper_ms_per_query": 1.5,
        "pool.evictions_per_query": 3.0, "distance.copies_per_call": 3.0})
    assert set(got) == set(tool.READINGS)
    # a span the run never opened reads 0; without the recorder, no span reading
    assert tool.readings({"engine.run": (1, MS, MS)}, {}, 1)["kernels.wrapper_ms_per_query"] == 0
    assert set(tool.readings(None, counters, 2)) == {"pool.evictions_per_query",
                                                     "distance.copies_per_call"}
    assert tool.readings(None, {}, 2) == {} and tool.readings(port, counters, 0) == {}
    cov = tool.coverage(port, 0.05, {"engine": 1.0, "search.step": 3.0, "harness": 1.0})
    assert cov["self_over_engine_run"] == pytest.approx(1.0)
    assert cov["engine_run_over_harness_engine"] == pytest.approx(0.8)
    assert cov["harness_idle_share"] == pytest.approx(0.4)


def test_engine_counters_gain_evictions_and_copies(monkeypatch, tmp_path):
    snaps: list = []
    monkeypatch.setattr(registry, "driver", tool._counting(registry.driver, snaps))
    result, _ = tiny.run(tiny.ENGINE, tmp_path)
    assert result["correct"] is True
    c0, c1 = snaps[-2], snaps[-1]
    window = {k: c1[k] - c0[k] for k in c1}
    got = tool.readings(None, window, result["attempted"])
    assert got["pool.evictions_per_query"] > 0
    # one query a call, fusion off: every level-1 or level-2 call ships its
    # query and its ids and brings one result back
    assert got["distance.copies_per_call"] == 3.0


def test_the_tool_splits_a_small_engine_window(monkeypatch, tmp_path, capsys):
    cell, cfg = tiny.cell(tiny.ENGINE)
    monkeypatch.setattr(registry, "cell", lambda name, here=None: cell)
    monkeypatch.setattr(registry, "config", lambda name, here=None: cfg)
    monkeypatch.setattr(registry, "driver", registry.driver)  # the tool wraps it
    monkeypatch.setattr(trace, "Window", trace.Window)  # the tool replaces it
    monkeypatch.setattr(index_cache, "CACHE_DIR", tmp_path)
    out = tmp_path / "out.json"
    assert tool.main(["--seed", str(tiny.SEED), "--seconds", "0.5", "--profiler", "0",
                      "--device", "cpu", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == got
    assert got["correct"] and got["queries"] > 0 and got["spans"] > 0
    assert set(got["readings"]) == set(tool.READINGS)
    assert got["readings"]["kernels.wrapper_ms_per_query"] == 0  # no card
    assert got["readings"]["distance.copies_per_call"] == 3.0
    cov = got["coverage"]
    assert cov["self_over_engine_run"] == pytest.approx(1.0)
    assert 0.9 < cov["engine_run_over_harness_engine"] <= 1.0
    assert cov["harness_idle_share"] < 0.1
    assert set(got["totals_s"]) == {"engine.run", "search.step", "store.decode", "pool.admit",
                                    "distance.execute", "distance.h2d", "distance.d2h"}
