"""The inner-product cell ``text2image-scan.b4096`` at small sizes: its
driver judged correct on the CPU, planted faults and the control failing
its limits, the registry placing it under ``.scan``, its frozen generator
and reference encoding equal to the port's bit for bit, and its two
per-layer readers.  Its run on the card is the last case, marked ``cuda``."""

import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
for _p in (str(REPO), str(REPO / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from repro_torch.core.quant import RabitQuantizer, pack_bits, pack_nibbles  # noqa: E402
from repro_torch.velo import scan_search as scan_mod  # noqa: E402

from velobench import data_ip, harness, judge, registry, roofline_select  # noqa: E402
from velobench.reference import rabitq_ip  # noqa: E402

CELL = "text2image-scan.b4096"
SEED = 2**31 + 4242  # beyond 32 signed bits, as the driver's seeds may be
BENCH = registry.benchmark()
LIMITS = registry.cell(CELL)["limits"]


def _tiny() -> tuple[dict, dict]:
    """The cell at 5 000 rows (chunks of 1 024 and a tail of 904), d 200
    padded to 224, 64 queries a call from a pool of 300."""
    c = registry.cell(CELL)
    cfg = registry.config(c["config"])
    cfg.update(n=5000, chunk=1024)
    c["traffic"].update(pool=300, batch=64, sample=60)
    return c, cfg


def _run(*, control=False, device="cpu", trace=False, seconds=0.5):
    c, cfg = _tiny()
    return harness.run_cell(CELL, SEED, seconds, trace, device, time.perf_counter(), cell=c,
                            cfg=cfg, control=control, log=lambda msg: None)


def test_the_files_state_the_deployment():
    cfg = registry.config("text2image-scan")
    assert (cfg["n"], cfg["d"], cfg["D"], cfg["metric"], cfg["k"], cfg["R"]) == \
        (1953125, 200, 224, "ip", 10, 32)
    assert (cfg["rerank"], cfg["query_batch"], cfg["chunk"], cfg["queries"]) == \
        (64, 4096, 32768, 10000)
    assert cfg["chips_sharing_the_corpus"] * cfg["n"] == cfg["corpus_size"] == 10**9
    assert cfg["reduced"] == [] and cfg["data_seed"] == 0
    assert cfg["D"] == rabitq_ip.padded(cfg["d"])
    cell = registry.cell(CELL)
    assert cell["driver"] == "scan_ip" and cell["chips"] == 1
    assert cell["traffic"] == {"name": "b4096", "batch": 4096, "pool": 10000,
                               "query_skew": 1.2, "sample": 1024}
    assert set(cell["limits"]) == {"bad_answers", "score_gap", "id_mismatch"}
    for ref in cfg["reference"]:
        assert (registry.HERE / ref).is_file()


def test_registry_finds_the_cell_under_scan():
    from test_velobench_registry import bound_class

    assert bound_class(BENCH, CELL) == "scan"
    untraced = {m["name"] for m in registry.metrics_for(BENCH, CELL, False)}
    assert untraced == {"qps.scan", "p95_ms.scan", "recall_at_10.scan", "setup_s"}
    traced = {m["name"] for m in registry.metrics_for(BENCH, CELL, True)}
    assert traced == {"binary_ip_roofline", "device.idle_share.scan", "scan_select_ip_roofline",
                      "scan_select_ip_full_rows_per_call"}
    for name in traced:
        assert registry.metric(name).read(types.SimpleNamespace(
            trace=None, launch_shapes={}, counters={}, calls=0)) is None


def test_generator_and_reference_encoding_are_the_ports_bits():
    cfg = registry.config("text2image-scan")
    base, pool = data_ip.generate(3000, 200, 50, 5, 1.2, cfg["noise"], cfg["norm_spread"],
                                  cfg["query_shift"])
    again, pool2 = data_ip.generate(3000, 200, 50, 5, 1.2, cfg["noise"], cfg["norm_spread"],
                                    cfg["query_shift"])
    assert np.array_equal(base, again) and np.array_equal(pool, pool2)
    norms = np.linalg.norm(base, axis=1)
    assert norms.std() / norms.mean() > 0.2  # norms vary: not cosine in disguise
    # out of distribution: the queries' mean lies off the base's by the offset
    shift = np.linalg.norm(pool.mean(0) - base.mean(0))
    assert shift > 0.5 * cfg["noise"] * np.sqrt(200)
    qb = RabitQuantizer(200, seed=5, metric="ip").fit_encode(base)
    enc = rabitq_ip.encode(base, 5)
    assert np.array_equal(qb.centroid, enc.centroid) and np.array_equal(qb.rotation, enc.rotation)
    assert np.array_equal(qb.binary_codes, pack_bits(enc.signs))
    assert np.array_equal(qb.ext_codes, pack_nibbles(enc.codes))
    for a, b in ((qb.norms, enc.norms), (qb.ip_bar, enc.ip_bar), (qb.ext_lo, enc.lo),
                 (qb.ext_step, enc.step), (qb.cr, enc.cr)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_driver_is_correct_on_the_cpu():
    result, lines = _run()
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"qps.scan", "p95_ms.scan", "recall_at_10.scan", "setup_s"}
    assert result["metrics"]["recall_at_10.scan"]["value"] > 0.5
    assert result["checks"]["score_gap"]["value"] < LIMITS["score_gap"] / 10
    assert lines[-1] == "correct: True"


def _wrong(result, number):
    assert result["correct"] is False
    assert result["checks"][number]["value"] > result["checks"][number]["limit"]


def test_scores_off_by_a_tenth_of_a_percent_fail(monkeypatch):
    scan = scan_mod.scan_search

    def altered(*a, **kw):
        ids, score = scan(*a, **kw)
        return ids, score * 1.001

    monkeypatch.setattr(scan_mod, "scan_search", altered)
    result = _run()[0]
    _wrong(result, "score_gap")
    assert result["failed"] > 0


def test_cr_dropped_fails(monkeypatch):
    drv = registry.driver("scan_ip")
    from_host = drv.velo_index.from_host

    def no_cr(qb, graph, device=None):
        index = from_host(qb, graph, device=device)
        index.cr[:-1] = 0.0
        return index

    monkeypatch.setattr(drv.velo_index, "from_host", no_cr)
    result = _run()[0]
    _wrong(result, "score_gap")


def test_an_l2_estimator_on_the_ip_index_fails(monkeypatch):
    block = scan_mod.stage1_block

    def l2(*a, **kw):
        kw["cr_blk"] = None
        return block(*a[:6], **kw)

    monkeypatch.setattr(scan_mod, "stage1_block", l2)
    result = _run()[0]
    _wrong(result, "id_mismatch")
    assert result["checks"]["bad_answers"]["value"] == 0


def test_control_is_not_correct():
    result, _ = _run(control=True)
    assert judge.verdict(result["numbers"], LIMITS)[0] is True
    ok, checks = judge.verdict(result["control"], LIMITS)
    assert ok is False
    assert checks["score_gap"]["value"] > 10 * LIMITS["score_gap"]


def test_scan_select_bytes_at_the_cells_chunk():
    B, L, C = 4096, 32768, 64
    nbytes = roofline_select.scan_select_bytes(B, L, C, True)
    assert nbytes == B * L * 4 + L * 8 + B * 2 + 2 * B * C * 10
    assert roofline_select.scan_select_bytes(B, L, C, False) == nbytes - B * C * 10
    assert roofline_select.scan_select_bound_s(B, L, C, True) == pytest.approx(nbytes / 3.35e12)


def _run_ns(**kw):
    base = dict(queries=100, calls=4, window_s=2.0, setup_s=5.0, latencies_s=[0.1] * 100,
                recall=0.9, counters={}, spans_s={}, trace=None, launch_shapes={})
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_ip_readers():
    m = registry.metric("scan_select_ip_roofline")
    shapes = [(64, 1024, 32, True)] * 2 + [(64, 904, 32, True)]
    bound = sum(roofline_select.scan_select_bound_s(*s) for s in shapes)
    ops = {"void (anonymous namespace)::scan_select_ip_kernel<1, 4>(...)": [12, 8 * bound],
           "void (anonymous namespace)::scan_select_kernel<1, 4>(...)": [5, 1.0]}
    r = m.read(_run_ns(calls=4, launch_shapes={"scan_select": shapes},
                       trace=dict(ops=ops, busy_s=1, window_s=2)))
    assert r == pytest.approx(100 * 4 * bound / (8 * bound))
    ops[next(iter(ops))][0] = 11  # a launch the shapes do not explain
    assert m.read(_run_ns(calls=4, launch_shapes={"scan_select": shapes},
                          trace=dict(ops=ops, busy_s=1, window_s=2))) is None
    f = registry.metric("scan_select_ip_full_rows_per_call")
    assert f.read(_run_ns(calls=4, counters={"scan_select.full_select_rows": 10})) == 2.5
    assert f.read(_run_ns()) is None


def test_bench_entries_are_appended_only():
    """Every accepted entry keeps its place; the new ones come last."""
    names = [w["name"] for w in BENCH["workloads"]]
    assert names[-1] == CELL
    assert [c["name"] for c in BENCH["configs"]][-1] == "text2image-scan"
    assert [m["name"] for m in BENCH["per_layer"]][-2:] == [
        "scan_select_ip_roofline", "scan_select_ip_full_rows_per_call"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        if CELL in m.get("workloads", []):
            assert m["workloads"][-1] == CELL
    assert json.loads((REPO / "BENCHMARK.json").read_text()) == BENCH


@pytest.mark.cuda
def test_driver_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    from repro_torch.kernels.scan_select import kernel as sel_kernel

    i0 = sel_kernel.ip_launches
    result, _ = _run(device="cuda", trace=True, seconds=1.0)
    assert result["correct"] is True, result["checks"]
    assert sel_kernel.ip_launches > i0
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    for name in ("scan_select_ip_roofline", "scan_select_ip_full_rows_per_call",
                 "device.idle_share.scan"):
        assert name in result["metrics"], name
    assert 0 < result["metrics"]["scan_select_ip_roofline"]["value"] <= 105


def test_half_the_batch_left_out_fails(monkeypatch):
    scan = scan_mod.scan_search

    def half(index, queries, *a, **kw):
        return scan(index, queries[: len(queries) // 2], *a, **kw)

    monkeypatch.setattr(scan_mod, "scan_search", half)
    result = _run()[0]
    _wrong(result, "bad_answers")
    assert result["failed"] > 0
