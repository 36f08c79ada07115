"""The traced window: ``torch.profiler`` over the card's activity, read into
device busy time, device time by operation, and idle time by what the host
was doing.

Only CUDA activity is traced (kernels, copies, fills): the engine issues
thousands of host operations a query, and tracing them would cost more than
the work.  The harness's own spans (``spans.py``) say what the host was
doing while the card sat idle.  Both clocks are ``time.time_ns()``; a marker kernel launched at a
known host time measures what offset remains between them."""

from __future__ import annotations

import bisect
import time

import torch

NAME_CHARS = 160


def _is_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


class Window:
    """Start the profiler on construction; ``stop()`` ends it and returns
    ``summarize``'s dict."""

    def __init__(self, spans):
        from torch.profiler import ProfilerActivity, profile

        self.spans = spans
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.marker_host = time.time_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        spans.events.clear()
        spans.record = True
        self.t0 = time.time_ns()

    def stop(self) -> dict:
        torch.cuda.synchronize()
        t1 = time.time_ns()
        self.spans.record = False
        self.prof.__exit__(None, None, None)
        evs = [(e.name(), e.start_ns(), e.duration_ns())
               for e in self.prof.profiler.kineto_results.events() if _is_device(e)]
        markers = [s for name, s, _ in evs if "spin_kernel" in name]
        offset = (min(markers) - self.marker_host) if markers else 0
        evs = [e for e in evs if "spin_kernel" not in e[0]]
        return summarize(evs, self.spans.timeline(), self.t0 + offset, t1 + offset, offset)


def summarize(events, timeline, w0: int, w1: int, offset: int = 0) -> dict:
    """``events``: (name, start_ns, duration_ns) of device operations on the
    device clock; ``timeline``: what the host was doing, as sorted change
    points (host_ns, label) (``Spans.timeline``); [w0, w1]: the traced
    window on the device clock, ``offset`` the device clock less the host
    clock.  Returns the window's seconds, the device's busy seconds (the
    union of the operations' intervals), the operations' count and seconds
    by name, and the idle seconds split by what the host was doing during
    each part of each gap."""
    ops: dict[str, list] = {}
    spans = []
    for name, s, dur in events:
        e = s + dur
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        rec = ops.setdefault(name[:NAME_CHARS], [0, 0.0])
        rec[0] += 1
        rec[1] += (e - s) * 1e-9
        spans.append((s, e))
    spans.sort()
    busy_ns, idle = 0, {}
    cursor = w0

    times = [t + offset for t, _ in timeline]

    def gap(a, b):
        i = max(0, bisect.bisect_right(times, a) - 1)
        while a < b:
            end = min(b, times[i + 1]) if i + 1 < len(times) else b
            lab = timeline[i][1]
            idle[lab] = idle.get(lab, 0.0) + (end - a) * 1e-9
            a, i = end, i + 1

    for s, e in spans:
        if s > cursor:
            gap(cursor, s)
            busy_ns += e - s
            cursor = e
        elif e > cursor:
            busy_ns += e - cursor
            cursor = e
    gap(cursor, w1)
    return dict(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9, ops=ops, idle_s=idle)


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def breakdown(summary: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time and the idle time by what the host was doing."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1][1])[:top]
    idle = sorted(summary["idle_s"].items(), key=lambda kv: -kv[1])[:top]
    return dict(device_ops=[[name, rec[1]] for name, rec in ops],
                idle_gaps=[[name, s] for name, s in idle])
