"""The arithmetic that turns a trace into per-layer numbers: the roofline
bound, the union of device intervals, idle time by host span, and the
readers that use them."""

import sys
import time
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for _p in (str(REPO), str(REPO / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from velobench import registry, roofline, trace  # noqa: E402
from velobench.spans import Spans  # noqa: E402


def test_binary_ip_bound_at_the_scans_chunk():
    B, N, d = 4096, 32768, 128
    nbytes = N * d // 8 + B * d * 2 + B * N * 4
    t = roofline.binary_ip_bound_s(B, N, d)
    assert t == pytest.approx(nbytes / 3.35e12)          # bound by its output's bytes
    assert t > 2 * B * N * d / 989e12
    s, by = roofline.bound_s(1.0, 989e12, roofline.BF16_FLOP_PER_S)
    assert (s, by) == (1.0, "operations")


def test_summarize_unions_intervals_and_splits_gaps_by_span():
    # device ops on a clock 1000 ns ahead of the host's
    events = [("k1", 1100, 100), ("k2", 1150, 100), ("Memcpy HtoD", 1500, 50),
              ("k1", 1900, 200), ("early", 900, 50)]
    spans = Spans()
    spans.events += [("engine", 0, 800, 0), ("distance.estimate", 300, 500, 1)]
    s = trace.summarize(events, spans.timeline(), 1000, 2000, offset=1000)
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["busy_s"] == pytest.approx((150 + 50 + 100) * 1e-9)  # k2 overlaps k1; k1 clipped
    assert s["ops"]["k1"][0] == 2 and "early" not in s["ops"]
    # gaps on the host clock: [0,100) engine; [250,500) 50 engine + 200 estimate;
    # [550,900) 250 engine + 100 harness
    idle = {k: round(v * 1e9) for k, v in s["idle_s"].items()}
    assert idle == {"engine": 400, "distance.estimate": 200, "harness": 100}
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "k1" and b["idle_gaps"][0][0] == "engine"


def test_timeline_takes_the_innermost_span():
    sp = Spans()
    sp.record = True
    with sp.span("scan.call"):
        f = sp.wrap("distance.estimate", lambda: time.sleep(0.002))
        g = sp.wrap("distance.refine_ids", lambda: f())
        g()
    (outer,) = [e for e in sp.events if e[0] == "scan.call"]
    (inner,) = [e for e in sp.events if e[0] != "scan.call"]
    assert inner[0] == "distance.refine_ids"  # the nested wrapped call is not a span
    assert sp.count["distance.refine_ids"] == 1 and "distance.estimate" not in sp.count
    tl = sp.timeline()
    assert [lab for _, lab in tl] == ["harness", "scan.call", "distance.refine_ids",
                                      "scan.call", "harness"]
    assert [t for t, _ in tl][1:] == [outer[1], inner[1], inner[2], outer[2]]


def _run(**kw):
    base = dict(queries=100, calls=4, window_s=2.0, setup_s=5.0, latencies_s=[0.1] * 100,
                recall=0.9, counters={}, spans_s={}, trace=None, launch_shapes={})
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_roofline_reader_counts_launches_against_shapes():
    m = registry.metric("binary_ip_roofline")
    shapes = [(64, 1024, 128)] * 3
    bound = 3 * roofline.binary_ip_bound_s(64, 1024, 128)
    ops = {"binary_mma_kernel<...>": [3 * 4, 8 * bound], "sort": [5, 1.0]}
    r = m.read(_run(calls=4, launch_shapes={"binary_ip": shapes},
                    trace=dict(ops=ops, busy_s=1, window_s=2)))
    assert r == pytest.approx(100 * 4 * bound / (8 * bound))
    ops["binary_mma_kernel<...>"][0] = 11  # a launch the shapes do not explain
    assert m.read(_run(calls=4, launch_shapes={"binary_ip": shapes},
                       trace=dict(ops=ops, busy_s=1, window_s=2))) is None
    assert m.read(_run()) is None


def test_trace_readers():
    ops = {"DeviceSegmentedRadixSortKernel": [10, 3.0], "binary_mma_kernel": [4, 1.0],
           "Memcpy HtoD (Pageable -> Device)": [4, 1.0]}
    run = _run(calls=2, trace=dict(ops=ops, busy_s=1.5, window_s=2.0))
    assert registry.metric("scan.sort_share").read(run) == pytest.approx(0.6)
    assert registry.metric("scan.launches_per_call").read(run) == 7
    assert registry.metric("device.idle_share.scan").read(run) == pytest.approx(0.25)
    for name in ("scan.sort_share", "scan.launches_per_call", "device.idle_share.engine"):
        assert registry.metric(name).read(_run()) is None


def test_counter_and_span_readers():
    run = _run(counters={"cache_hits": 30, "cache_misses": 10, "io_count": 250,
                         "distance.level1_calls": 10, "distance.level1_rows": 150,
                         "distance.level2_calls": 10, "distance.level2_rows": 10,
                         "binary_ip.launches": 500, "int4_dist.launches": 700},
               spans_s={"engine": 1.5, "distance.estimate": 0.3, "distance.refine_ids": 0.2})
    assert registry.metric("pool.hit_rate").read(run) == 0.75
    assert registry.metric("ssd.reads_per_query").read(run) == 2.5
    assert registry.metric("distance.rows_per_call").read(run) == 8.0
    assert registry.metric("kernels.launches_per_query").read(run) == 12.0
    assert registry.metric("distance.ms_per_query").read(run) == pytest.approx(5.0)
    assert registry.metric("engine.host_ms_per_query").read(run) == pytest.approx(10.0)
    assert registry.metric("qps.engine").read(run) == 50.0
    assert registry.metric("p95_ms.scan").read(run) == pytest.approx(100.0)
    assert registry.metric("pool.hit_rate").read(_run()) is None
