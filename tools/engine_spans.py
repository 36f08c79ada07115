#!/usr/bin/env python3
"""The engine cell's host time split by the port's spans, on the card.

    python3 tools/engine_spans.py --seed N [--seconds 51] [--port 1|0] [--profiler 1|0]
                                  [--device cuda] [--out OUT.json]

Runs one traced window of the benchmark's engine cell (``sift1m-velo.zipf``)
as ``velobench/run.py --trace 1`` does (``velobench.harness.run_cell``: the same set-up, warm-up, window,
profiler and reference), and with ``--port 1`` (the default) turns the port's
span recorder (``repro_torch.tracing``) on and off with the profiler.  The
idle gaps of the device trace are then labelled by the innermost port span
open in each part of each gap, and by the harness's own span where none is;
the engine cell's counters gain the record pool's evictions and the distance
plane's host copies, as window deltas.  ``--port 0`` is the benchmark's own
traced run with the counters added, the base against which the recorder's
cost is read.  ``--profiler 0`` leaves the profiler off, as in an untraced
run, whose CUDA calls it does not slow: the spans then split the host's
time alone, and every part of the window counts as idle (``--device cpu``
runs it on the CPU, with the kernels' plain versions and no
``kernels.launch``).

Prints one JSON object (and writes it to OUT.json when given): the run's
result line, its queries per second, the port's totals by span (count,
seconds, self seconds), the readings of the ten per-layer quantities that
the spans and counters give (``READINGS``), and the coverage checks: the
port's self times against ``engine.run``'s total, ``engine.run`` against the
harness's ``engine`` span, and the share of idle time left under a harness
label.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

WORKLOAD = "sift1m-velo.zipf"
# span-based readings: name -> (span, 1 for its total or 2 for its self time)
SPAN_READINGS = {
    "engine.sched_ms_per_query": ("engine.run", 2),
    "search.step_ms_per_query": ("search.step", 2),
    "store.decode_ms_per_query": ("store.decode", 1),
    "pool.admit_ms_per_query": ("pool.admit", 1),
    "distance.prep_ms_per_query": ("distance.execute", 2),
    "distance.h2d_ms_per_query": ("distance.h2d", 1),
    "distance.d2h_ms_per_query": ("distance.d2h", 1),
    "kernels.wrapper_ms_per_query": ("kernels.launch", 1),
}
READINGS = (*SPAN_READINGS, "pool.evictions_per_query", "distance.copies_per_call")


def readings(port: dict | None, counters: dict, queries: int) -> dict:
    """The per-layer readings of a window: ``port`` is the recorder's totals
    by span name, (count, total ns, self ns), or None when it was off;
    ``counters`` the window's counter deltas.  A reading whose source the
    run lacks is left out."""
    out = {}
    if not queries:
        return out
    if port is not None:
        for name, (span, part) in SPAN_READINGS.items():
            rec = port.get(span)
            out[name] = (rec[part] if rec else 0) / queries * 1e-6
    if "pool.evictions" in counters:
        out["pool.evictions_per_query"] = counters["pool.evictions"] / queries
    calls = counters.get("distance.level1_calls", 0) + counters.get("distance.level2_calls", 0)
    if "distance.h2d_copies" in counters and calls:
        out["distance.copies_per_call"] = (
            counters["distance.h2d_copies"] + counters["distance.d2h_copies"]) / calls
    return out


def relabel(harness: list, times, labels: list) -> list:
    """One timeline from the harness's change points (t_ns, label) and the
    port's (``times``, ``labels``, None where no port span is open), both
    sorted: from each point on, the innermost port span open, or the
    harness's label where none is."""
    times = [int(t) for t in times]
    out, h_label, p_label = [], None, None
    i = j = 0
    while i < len(harness) or j < len(times):
        if j == len(times) or (i < len(harness) and harness[i][0] <= times[j]):
            t, h_label = harness[i]
            i += 1
        else:
            t, p_label = times[j], labels[j]
            j += 1
        out.append((t, h_label if p_label is None else p_label))
    return out


def coverage(port: dict, harness_engine_s: float, idle_s: dict) -> dict:
    """The port's self times over ``engine.run``'s total (1 when every span
    nests in it), ``engine.run`` over the harness's ``engine`` span, and the
    share of the idle time under a label of the harness's alone."""
    run_ns = port.get("engine.run", (0, 0, 0))[1]
    idle = sum(idle_s.values())
    return dict(
        self_over_engine_run=sum(s for _, _, s in port.values()) / run_ns if run_ns else None,
        engine_run_over_harness_engine=run_ns * 1e-9 / harness_engine_s
        if harness_engine_s else None,
        harness_idle_share=sum(v for k, v in idle_s.items() if k not in port) / idle
        if idle else None)


def _counting(load, snapshots: list):
    """``registry.driver`` whose engine ``Driver.counters`` also reads the
    pool's evictions and the distance plane's copy counters, and keeps every
    reading in ``snapshots``."""

    def driver(name, here=None):
        mod = load(name, here)
        counters = mod.Driver.counters

        def more(self):
            out = counters(self)
            pool = getattr(self, "pool_obj", None)
            if pool is not None:
                st = self.system.ctx.dist.stats
                out.update({"pool.evictions": pool.evictions,
                            "distance.h2d_copies": st.h2d_copies,
                            "distance.d2h_copies": st.d2h_copies})
            snapshots.append(out)
            return out

        mod.Driver.counters = more
        return mod

    return driver


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--port", type=int, choices=(0, 1), default=1)
    ap.add_argument("--profiler", type=int, choices=(0, 1), default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.profiler and args.device != "cuda":
        ap.error("the profiler traces a CUDA card: --profiler 0 on another device")

    from repro_torch import tracing
    from velobench import harness, registry
    from velobench import trace as trace_mod

    state: dict = {}

    class PortWindow(trace_mod.Window):
        """The benchmark's traced window with the port's recorder on."""

        def __init__(self, spans):
            if args.profiler:
                super().__init__(spans)
            else:
                self.spans = spans
                spans.events.clear()
                spans.record = True
                self.t0 = time.time_ns()
            if args.port:
                tracing.start()

        def stop(self):
            state["engine_s"] = self.spans.total_s.get("engine", 0.0)
            if args.port:
                rec = tracing.stop()
                state["port"] = rec.totals
                state["spans"] = len(rec)
                times, labels = rec.timeline()
                own = self.spans.timeline
                # the summary's idle gaps read the merged timeline
                self.spans.timeline = lambda: relabel(own(), times, labels)
            if args.profiler:
                out = super().stop()
            else:
                t1 = time.time_ns()
                self.spans.record = False
                out = trace_mod.summarize([], self.spans.timeline(), self.t0, t1)
            state["idle_s"] = out["idle_s"]
            return out

    snapshots: list = []
    trace_mod.Window = PortWindow
    registry.driver = _counting(registry.driver, snapshots)
    result, lines = harness.run_cell(WORKLOAD, args.seed, args.seconds, True, args.device,
                                     t_start)
    c0, c1 = snapshots[-2], snapshots[-1]
    counters = {k: c1[k] - c0.get(k, 0) for k in c1}
    queries = result["attempted"]
    window_s = result["device"]["window_s"]
    port = state.get("port")
    out = dict(
        workload=WORKLOAD, seed=args.seed, port=bool(args.port),
        profiler=bool(args.profiler), correct=result["correct"],
        queries=queries, window_s=window_s, qps=queries / window_s,
        spans=state.get("spans", 0), harness_engine_s=state["engine_s"],
        totals_s={k: [c, t * 1e-9, s * 1e-9] for k, (c, t, s) in (port or {}).items()},
        readings=readings(port, counters, queries),
        coverage=coverage(port, state["engine_s"], state["idle_s"]) if port else None,
        counters=counters, result=result)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    for line in lines:
        print(line, file=sys.stderr)
    print(text, flush=True)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
