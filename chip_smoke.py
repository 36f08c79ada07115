#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port of VeloANN.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases (each one that fails ends the run with a non-zero exit):
  1. device   require CUDA, print the card's name and power limit, turn TF32 off
  2. build    compile src/repro_torch/csrc/*.cu for sm_90a (one nvcc each, in
              parallel) into build/kernels/librepro_torch_kernels.so
  3. kernels  each CUDA kernel against its plain PyTorch version on the card at
              the search path's shapes and at SIFT1M scale: max error, kernel,
              plain and library-yardstick times (CUDA events, median of 30),
              and the least time the card could take (the bound)
  4. tables   a 1M x 128 index registered once in the torch distance engine;
              fused estimate / refine / beam-step calls held against the NumPy
              batch engine on the same ids
  5. search   VeloANN's search path end to end (build_system("velo") + run) on
              a 10 000 x 128 index, torch engine on the card with fuse on and
              device_beam off/on, against the batch engine on the same index;
              the kernels' launch counters are set to 0 before each torch run
              and read after it
  6. report   one JSON line of per-kernel numbers, then the card line and the
              final {"ok": true, ...} line

Imports torch, numpy and the port (src/repro_torch) only.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import baselines, dataset, distance, vamana  # noqa: E402
from repro_torch.core import beam as beam_mod  # noqa: E402
from repro_torch.core.quant import RabitQuantizer  # noqa: E402
from repro_torch.device import kernels_built  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.binary_ip import kernel as bip_kernel  # noqa: E402
from repro_torch.kernels.binary_ip import ops as bip_ops  # noqa: E402
from repro_torch.kernels.binary_ip import ref as bip_ref  # noqa: E402
from repro_torch.kernels.int4_dist import kernel as i4_kernel  # noqa: E402
from repro_torch.kernels.int4_dist import ops as i4_ops  # noqa: E402
from repro_torch.kernels.int4_dist import ref as i4_ref  # noqa: E402

# H100 SXM data-sheet peaks: HBM3 bytes/s and fp32 (non-tensor) flop/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# kernel vs plain: fp32 sums in another order (tests/test_kernels.py's bars)
TOL = {"binary_ip": dict(rtol=1e-5, atol=1e-4), "int4_dist": dict(rtol=1e-4, atol=1e-3)}
# engine vs the NumPy batch engine, whose estimator epilogue is float64
HOST_TOL = dict(rtol=2e-3, atol=2e-3)
KERNELS = {
    "binary_ip": dict(source="src/repro_torch/csrc/binary_ip.cu",
                      replaces="src/repro/kernels/binary_ip/kernel.py:28",
                      counter=bip_kernel),
    "int4_dist": dict(source="src/repro_torch/csrc/int4_dist.cu",
                      replaces="src/repro/kernels/int4_dist/kernel.py:27",
                      counter=i4_kernel),
}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    torch.cuda.synchronize()
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def host_ms(fn, reps: int = 20) -> float:
    """Median wall time of one call that ends on the host (results downloaded)."""
    fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def device_us(fn, reps: int = 30) -> float | None:
    """Device time of one call in microseconds: the summed self time of the
    kernels the CUDA profiler (CUPTI) records over ``reps`` calls, per call.
    None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages())
    return total / reps if total > 0 else None


def bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phase 3


def check_binary_ip(dev, gen, B, N, d, T, gather, q_dtype=torch.float32) -> dict:
    q = torch.randn(B, d, generator=gen, device=dev).to(q_dtype)
    codes = torch.randint(0, 256, (T, d // 8), generator=gen, device=dev, dtype=torch.uint8)
    ids = torch.randint(0, T, (N,), generator=gen, device=dev) if gather else None
    got = bip_ops.binary_ip(q, codes, ids)
    rows = codes if ids is None else codes[ids]
    want = bip_ref.binary_ip_ref(q, rows)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(torch.allclose(got, want, **TOL["binary_ip"]),
            f"binary_ip disagrees with its plain version at B={B} N={N} d={d}: {err}")
    signs = bip_ref.unpack_signs(rows, d)
    qf = q.float()

    def plain():
        return bip_ref.binary_ip_ref(q, codes if ids is None else codes[ids])

    nbytes = q.numel() * q.element_size() + N * d // 8 + (N * 8 if gather else 0) + B * N * 4
    b_ms, b_by = bound_ms(nbytes, 2 * B * N * d)
    return dict(
        kernel="binary_ip", B=B, N=N, d=d, table=T, gather=gather, q=str(q_dtype)[6:],
        max_abs_err=err,
        ms=time_ms(lambda: bip_ops.binary_ip(q, codes, ids)),
        plain_ms=time_ms(plain),
        library_ms=time_ms(lambda: torch.matmul(qf, signs.T)),
        device_us=device_us(lambda: bip_ops.binary_ip(q, codes, ids)),
        plain_device_us=device_us(plain),
        bound_ms=b_ms, bound_by=b_by,
    )


def check_int4_dist(dev, gen, B, N, d, T, gather) -> dict:
    q = torch.randn(B, d, generator=gen, device=dev)
    codes = torch.randint(0, 256, (T, d // 2), generator=gen, device=dev, dtype=torch.uint8)
    lo = torch.rand(T, generator=gen, device=dev) - 2.0
    step = torch.rand(T, generator=gen, device=dev) * 0.2 + 0.1
    ids = torch.randint(0, T, (N,), generator=gen, device=dev) if gather else None
    got = i4_ops.int4_dist2(q, codes, lo, step, ids)
    rows = (codes, lo, step) if ids is None else (codes[ids], lo[ids], step[ids])
    want = i4_ref.int4_dist2_ref(q, *rows)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(torch.allclose(got, want, **TOL["int4_dist"]),
            f"int4_dist disagrees with its plain version at B={B} N={N} d={d}: {err}")
    x = i4_ref.unpack_nibbles(rows[0], d) * rows[2][:, None] + rows[1][:, None]

    def plain():
        r = (codes, lo, step) if ids is None else (codes[ids], lo[ids], step[ids])
        return i4_ref.int4_dist2_ref(q, *r)

    nbytes = B * d * 4 + N * (d // 2 + 8) + (N * 8 if gather else 0) + B * N * 4
    b_ms, b_by = bound_ms(nbytes, 2 * B * N * d + 4 * N * d)
    return dict(
        kernel="int4_dist", B=B, N=N, d=d, table=T, gather=gather, q="float32",
        max_abs_err=err,
        ms=time_ms(lambda: i4_ops.int4_dist2(q, codes, lo, step, ids)),
        plain_ms=time_ms(plain),
        library_ms=time_ms(lambda: torch.matmul(q, x.T)),
        device_us=device_us(lambda: i4_ops.int4_dist2(q, codes, lo, step, ids)),
        plain_device_us=device_us(plain),
        bound_ms=b_ms, bound_by=b_by,
    )


def _us(x: float | None) -> str:
    return "n/m" if x is None else f"{x:.2f}"


def phase_kernels(dev) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for d in (128, 960):
        for B in (1, 8):
            for N in (64, 256):
                rows.append(check_binary_ip(dev, gen, B, N, d, 10_000, gather=True))
                rows.append(check_int4_dist(dev, gen, B, N, d, 10_000, gather=True))
    rows.append(check_binary_ip(dev, gen, 8, 256, 960, 10_000, True, torch.bfloat16))
    for B in (1, 8):  # SIFT1M scale: a 1M x 128 resident table, 256 gathered rows
        rows.append(check_binary_ip(dev, gen, B, 256, 128, 1_000_000, gather=True))
        rows.append(check_int4_dist(dev, gen, B, 256, 128, 1_000_000, gather=True))
    rows.append(check_binary_ip(dev, gen, 8, 1_000_000, 128, 1_000_000, gather=False))
    rows.append(check_int4_dist(dev, gen, 8, 1_000_000, 128, 1_000_000, gather=False))
    print(f"{'kernel':10} {'B':>2} {'N':>8} {'d':>4} {'table':>8} {'q':>8} "
          f"{'max_err':>9} {'ms':>9} {'plain_ms':>9} {'lib_ms':>9} {'bound_ms':>9} "
          f"{'dev_us':>8} {'pl_dev_us':>9} by")
    for r in rows:
        print(f"{r['kernel']:10} {r['B']:>2} {r['N']:>8} {r['d']:>4} {r['table']:>8} "
              f"{r['q']:>8} {r['max_abs_err']:9.2e} {r['ms']:9.5f} {r['plain_ms']:9.5f} "
              f"{r['library_ms']:9.5f} {r['bound_ms']:9.6f} {_us(r['device_us']):>8} "
              f"{_us(r['plain_device_us']):>9} {r['bound_by']}")
    return rows


# ------------------------------------------------------------------ phase 4


def phase_tables(rng, n: int = 1_000_000, d: int = 128) -> dict:
    base = rng.standard_normal((n, d), dtype=np.float32)
    t0 = time.perf_counter()
    qb = RabitQuantizer(d, seed=0).fit_encode(base)
    fit_s = time.perf_counter() - t0
    pqs = [RabitQuantizer.prepare_query(qb, q)
           for q in rng.standard_normal((8, d), dtype=np.float32)]
    eng = distance.get_engine("torch")
    host = distance.get_engine("batch")
    torch.cuda.reset_peak_memory_stats()
    eng.register_index(qb)
    require(eng.stats.uploads == 1, "registering the 1M table must be one upload")
    groups = [(pq, rng.integers(0, n, 32)) for pq in pqs]  # one flush: B=8, 256 rows
    for fn in ("estimate_many", "refine_ids_many"):
        for g, w in zip(getattr(eng, fn)(qb, groups), getattr(host, fn)(qb, groups)):
            require(np.allclose(g, w, **HOST_TOL), f"{fn} disagrees with the batch engine")
    est_ms = host_ms(lambda: eng.estimate_many(qb, groups))
    ref_ms = host_ms(lambda: eng.refine_ids_many(qb, groups))

    # a chain of fused beam steps over ids drawn from the whole table
    L = 64
    st = [eng.beam_new(L, n) for _ in pqs]
    hst = [host.beam_new(L, n) for _ in pqs]
    prev = [np.empty(0, np.int64)] * len(pqs)
    same, total, step_ms = 0, 0, []
    for k in range(10):
        kw = [dict(fresh=rng.integers(0, n, 32), explored=prev[i][:1]) for i in range(len(pqs))]

        def reqs(states):
            return [beam_mod.BeamRequest(
                kind="estimate", state=s, fresh=kw[i]["fresh"], explored=kw[i]["explored"],
                insert_ids=np.empty(0, np.int64), insert_ds=np.empty(0, np.float32),
                rows=32, flop_s=0.0, pq=pqs[i], qb=qb) for i, s in enumerate(states)]

        t0 = time.perf_counter()
        got = eng.beam_step_many(qb, reqs(st))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        want = host.beam_step_many(qb, reqs(hst))
        for i, (g, w) in enumerate(zip(got, want)):
            require(g.window_len == w.window_len, f"beam step {k}: window length")
            require(np.isclose(g.tail, w.tail, **HOST_TOL),
                    f"beam step {k}: tail {g.tail} vs {w.tail}")
            same += int(np.array_equal(g.frontier, w.frontier))
            total += 1
        prev = [g.frontier for g in got]
    for s, h in zip(st, hst):
        require(np.allclose(s.cand_d.cpu().numpy(), h.cand_d, **HOST_TOL),
                "beam heaps disagree with the batch engine")
    peak = torch.cuda.max_memory_allocated()
    out = dict(fit_encode_s=fit_s, estimate_many_ms=est_ms, refine_ids_many_ms=ref_ms,
               beam_step_ms=float(np.median(step_ms[1:])), beam_frontiers_equal=same / total,
               max_memory_allocated=peak, uploads=eng.stats.uploads)
    require(eng.stats.uploads == 1, "the 1M table must stay registered once")
    print("tables:", json.dumps(out))
    return out


# ------------------------------------------------------------------ phase 5


def _velo(ds, graph, qb, backend, device_beam):
    cfg = baselines.SystemConfig(
        buffer_ratio=0.2, batch_size=8, distance_backend=backend, fuse=True,
        device_beam=device_beam, params=baselines.SearchParams(L=64, W=4),
    )
    return baselines.build_system("velo", ds.base, graph, qb, cfg)


def _search(ds, graph, qb, backend, device_beam) -> dict:
    system = _velo(ds, graph, qb, backend, device_beam)
    for spec in KERNELS.values():
        spec["counter"].launches = 0
    t0 = time.perf_counter()
    results, stats = system.run(ds.queries)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: spec["counter"].launches for name, spec in KERNELS.items()}
    ids = np.full((len(results), ds.k), -1, dtype=np.int64)
    for i, r in enumerate(results):
        ids[i, : min(ds.k, len(r.ids))] = r.ids[: ds.k]
    return dict(backend=system.ctx.dist.name, device_beam=device_beam, ids=ids,
                recall=dataset.recall_at_k(ids, ds.groundtruth, ds.k),
                simulated_qps=stats.qps, wall_s=wall, launches=launches,
                dist_uploads=system.ctx.dist.stats.uploads)


def phase_search(n: int = 10_000, d: int = 128) -> dict:
    t0 = time.perf_counter()
    ds = dataset.make_dataset(n=n, d=d, n_queries=200, seed=0)
    graph = vamana.build_vamana(ds.base, R=32, L=64, seed=0)
    qb = RabitQuantizer(ds.dim, seed=0).fit_encode(ds.base)
    build_s = time.perf_counter() - t0
    ref = _search(ds, graph, qb, "batch", False)
    runs = [_search(ds, graph, qb, "torch", beam) for beam in (False, True)]
    for r in runs:
        tag = f"torch device_beam={r['device_beam']}"
        require(r["backend"] == "torch", f"{tag}: the torch engine must serve")
        require(r["recall"] >= ref["recall"] - 0.01,
                f"{tag}: recall {r['recall']} below batch {ref['recall']} - 0.01")
        require(all(v > 0 for v in r["launches"].values()),
                f"{tag}: a kernel was not launched on the search path: {r['launches']}")
        require(r["dist_uploads"] == 1, f"{tag}: dist_uploads {r['dist_uploads']} != 1")
        r["equal_top10_share"] = float(np.mean(np.all(r["ids"] == ref["ids"], axis=1)))
    n_q = len(ds.queries)
    for r in [ref] + runs:
        r.pop("ids")
        r["launches_per_query"] = {k: v / n_q for k, v in r["launches"].items()}
        print("search:", json.dumps(r))
    print(f"search: index build {build_s:.1f} s (host NumPy), 200 queries per run")
    busy = _busy_share(ds, graph, qb)
    print("search: profiled torch run:", json.dumps(busy))
    return dict(build_s=build_s, batch=ref, torch=runs, profiled=busy)


def _busy_share(ds, graph, qb, n_queries: int = 50) -> dict:
    """The device's busy share on the torch search path (device_beam off):
    summed kernel time from the CUDA profiler over the wall time of a
    separate profiled run of ``n_queries`` (the profiler's own cost inflates
    this run's wall time, so the share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    system = _velo(ds, graph, qb, "torch", False)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        system.run(ds.queries[:n_queries])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    device_s = sum(e.self_device_time_total for e in avgs) / 1e6
    return dict(queries=n_queries, wall_s=wall, device_s=device_s,
                busy_share=device_s / wall,
                top=[[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in avgs[:8]])


# ------------------------------------------------------------------ main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    print("card:", card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(_build.sources())} sources, "
          f"loaded: {kernels_built()}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  ptxas:", line.strip())

    rows = phase_kernels(dev)
    tables = phase_tables(np.random.default_rng(0))
    search = phase_search()

    report = []
    for name, spec in KERNELS.items():
        # the flush shape at SIFT1M scale: 8 queries x 256 rows gathered by id
        # from the 1M-row resident table
        main = next(r for r in rows if r["kernel"] == name and r["B"] == 8
                    and r["N"] == 256 and r["table"] == 1_000_000)
        report.append(dict(
            name=name, route="cuda", source=spec["source"], replaces=spec["replaces"],
            launches=sum(r["launches"][name] for r in search["torch"]),
            max_abs_err=max(r["max_abs_err"] for r in rows if r["kernel"] == name),
            ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=main["library_ms"],
        ))
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(card=card, kernels=report, shapes=rows, tables=tables, search=search), indent=1))
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
