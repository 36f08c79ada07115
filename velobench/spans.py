"""The harness's spans: host-clock intervals around the calls it makes into
the port, kept in memory.

``span(name)`` wraps a block (a call of the port's entry point, the
warm-up); ``wrap(name, fn)`` wraps a method of the port so that each call is
a span, the outermost only when one wrapped method calls another.  Totals
by name are always kept; the intervals themselves only while ``record`` is
on (the traced window), in ``time.time_ns()``, the profiler's clock."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Spans:
    def __init__(self):
        self.total_s: dict[str, float] = defaultdict(float)
        self.count: dict[str, int] = defaultdict(int)
        self.record = False
        self.events: list[tuple[str, int, int, int]] = []  # (name, t0, t1, depth)
        self._depth = 0
        self._in_wrapped = False

    def reset(self) -> None:
        self.total_s.clear()
        self.count.clear()
        self.events.clear()

    def _close(self, name: str, t0: int, depth: int) -> None:
        t1 = time.time_ns()
        self.total_s[name] += (t1 - t0) * 1e-9
        self.count[name] += 1
        if self.record:
            self.events.append((name, t0, t1, depth))

    @contextlib.contextmanager
    def span(self, name: str):
        depth = self._depth
        self._depth += 1
        t0 = time.time_ns()
        try:
            yield
        finally:
            self._depth = depth
            self._close(name, t0, depth)

    def wrap(self, name: str, fn):
        def wrapped(*args, **kwargs):
            if self._in_wrapped:
                return fn(*args, **kwargs)
            self._in_wrapped = True
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self._in_wrapped = False
                self._close(name, t0, self._depth)

        wrapped.__wrapped__ = fn
        return wrapped

    def timeline(self) -> list[tuple[int, str]]:
        """The recorded spans as change points (t_ns, label), sorted: from
        each t_ns on, the innermost span open is ``label`` ("harness" when
        none is)."""
        points = []
        for name, t0, t1, depth in self.events:
            points.append((t0, 1, depth, name))
            points.append((t1, 0, -depth, name))
        points.sort()
        open_, out = [], [(-1, "harness")]
        for t, start, depth, name in points:
            if start:
                open_.append((depth, name))
            else:
                open_.remove((-depth, name))
            out.append((t, max(open_)[1] if open_ else "harness"))
        return out
