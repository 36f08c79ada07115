"""One run of one cell: set-up, warm-up, the measured window, the reference,
the metrics.  ``run.py`` is its command line; the tests drive it on the CPU
with small sizes.

Set-up runs from the process's start to the first timed call.  The window
runs back-to-back calls (a closed loop) until ``seconds`` have passed; the
call that crosses the end finishes, and the window's length is the time to
its end.  Once the window has closed the peak memory is read, the port's
state is freed, and the reference judges every answer that the window
produced.
"""

from __future__ import annotations

import gc
import sys
import time
import types

import torch

from velobench import judge, registry
from velobench import trace as trace_mod
from velobench.spans import Spans

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start: float, *,
             bench: dict | None = None, cell: dict | None = None, cfg: dict | None = None,
             control: bool = False, cache_dir=None, log=_log) -> tuple[dict, list[str]]:
    """(the result line as a dict, the check lines for standard error).
    ``cell`` and ``cfg`` replace the files' contents (the tests' small
    sizes); ``control`` also judges the reference in bf16 in the port's
    place and adds its numbers under ``control``."""
    bench = bench if bench is not None else registry.benchmark()
    cell = cell if cell is not None else registry.cell(name)
    cfg = cfg if cfg is not None else registry.config(cell["config"])
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    spans = Spans()
    drv = registry.driver(cell["driver"]).Driver(cfg, cell["traffic"], seed, device, spans,
                                                   log=log, cache_dir=cache_dir)
    with spans.span("warmup"):
        warm = drv.warmup()
    # what set-up built lives to the end: keep the collector from scanning it
    gc.collect()
    gc.freeze()
    c0 = drv.counters()
    drv.begin_window()
    spans.reset()
    window = trace_mod.Window(spans) if trace else None
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    latencies, ends = [], []
    while True:
        latencies += drv.call()
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    window_s, calls = ends[-1], len(ends)
    summary = window.stop() if window else None
    c1 = drv.counters()
    span_s = dict(spans.total_s)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"velobench: {name} seed {seed}: set-up {setup_s:.3f} s ({warm} warm-up calls), "
        f"window {window_s:.3f} s, {calls} calls, {len(latencies)} queries")
    log("velobench: call ends (s): " + " ".join(f"{e:.3f}" for e in ends))
    log("velobench: spans (s): " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(span_s.items())))

    ans = drv.answers()
    drv.release()
    gc.unfreeze()
    gc.collect()
    t_ref = time.perf_counter()
    out = drv.judge(ans, device)
    ok, checks = judge.verdict(out["numbers"], cell["limits"])
    failed = out["per_answer"]["bad"].copy()
    for k, lim in cell["limits"].items():
        if k in out["per_answer"]:
            failed |= out["per_answer"][k] > lim
    log(f"velobench: reference {time.perf_counter() - t_ref:.3f} s")

    run = types.SimpleNamespace(
        queries=len(latencies), calls=calls, window_s=window_s, setup_s=setup_s,
        latencies_s=latencies, recall=out["recall"],
        counters={k: c1[k] - c0.get(k, 0) for k in c1}, spans_s=span_s,
        trace=summary, launch_shapes=drv.launch_shapes())
    metrics = {}
    for m in registry.metrics_for(bench, name, trace):
        value = registry.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    dev_info = dict(platform="gpu" if cuda else "cpu",
                    kind=torch.cuda.get_device_name(device) if cuda else "cpu",
                    count=int(cell["chips"]) if cuda else 1, memory_peak_bytes=int(peak))
    if summary is not None:
        dev_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    result = dict(correct=ok, attempted=len(latencies), failed=int(failed.sum()),
                  metrics=metrics, device=dev_info)
    if summary is not None:
        result["breakdown"] = trace_mod.breakdown(summary)
    if control:
        result["control"] = drv.judge(ans, device, control=True)["numbers"]
        result["numbers"] = out["numbers"]
    result["checks"] = checks
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in checks.items()]
    lines.append(f"correct: {ok}")
    return result, lines

