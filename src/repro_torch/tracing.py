"""Spans of the port's host work on the wall clock, recorded in memory.

The recorder is off unless a caller turns it on around a workload::

    from repro_torch import tracing

    tracing.start()
    results, stats = system.run(queries)
    rec = tracing.stop()
    count, total_ns, self_ns = rec.totals["search.step"]

There is no exporter, no environment variable and no option: ``start()``
clears the recorder and turns it on, ``stop()`` turns it off and returns a
``Recording``.

A span has a name, a start and an end in ``time.time_ns()`` (the host clock
that ``velobench``'s device trace is aligned with), the index of the span
that encloses it, and a request id: the run (``engine.run`` spans opened since
``start``, counted from 0) and the query's index in that run, or -1 where no
query is known.  A span inherits its parent's query.  Spans nest strictly,
since the engine is one thread; a span that an exception left open is closed
when its parent ends.  The events are kept as columns, one entry a span, and
the totals by name (count, total ns and self ns: the duration less what the
span's direct children cover) are kept as spans close.  The columns are
``array('q')``, eight bytes an entry: a 51-s window of the engine holds about
10^6 spans.

While the recorder is off a site costs one read of the flag ``on`` and a
branch::

    sp = tracing.begin(SPAN) if tracing.on else -1
    ...                          # the work
    if sp >= 0:
        tracing.end(sp)

A span reads the host clock and nothing else: it never synchronises a device
and never changes a value, the order of operations or the engine's simulated
clock.
"""

from __future__ import annotations

import time
from array import array

import numpy as np

on = False  # the one flag every site reads

NAMES: list[str] = []  # span names by id
_ids: dict[str, int] = {}
_count: list[int] = []
_total: list[int] = []
_self: list[int] = []

# the events, one entry a span, in the order they opened
_name, _t0, _t1, _parent, _run, _qid = (array("q") for _ in range(6))
_stack: list[int] = []  # the open spans, outermost first
_kids: list[int] = []  # the ns their closed direct children cover
_runs = -1
_now = time.time_ns


def name(span: str) -> int:
    """The id of the span name ``span``, registered at its first use."""
    i = _ids.get(span)
    if i is None:
        i = _ids[span] = len(NAMES)
        NAMES.append(span)
        _count.append(0)
        _total.append(0)
        _self.append(0)
    return i


ENGINE_RUN = name("engine.run")


def begin(span: int, qid: int = -1) -> int:
    """Open a span of name id ``span`` (from ``name``) for query ``qid``;
    returns the index to ``end`` it with."""
    global _runs
    i = len(_t0)
    if _stack:
        parent = _stack[-1]
        if qid < 0:
            qid = _qid[parent]
    else:
        parent = -1
    if span == ENGINE_RUN:
        _runs += 1
    _name.append(span)
    _parent.append(parent)
    _run.append(_runs)
    _qid.append(qid)
    _t1.append(0)
    _stack.append(i)
    _kids.append(0)
    _t0.append(_now())
    return i


def end(i: int) -> None:
    """End span ``i``, and any span inside it that an exception left open."""
    t1 = _now()
    while _stack and _stack[-1] >= i:
        j = _stack.pop()
        d = t1 - _t0[j]
        _t1[j] = t1
        n = _name[j]
        _count[n] += 1
        _total[n] += d
        _self[n] += d - _kids.pop()
        if _kids:
            _kids[-1] += d


def start() -> None:
    """Clear the recorder and turn it on."""
    global on
    _clear()
    on = True


def stop() -> "Recording":
    """Turn the recorder off, close what is still open, and return what it
    recorded since ``start``."""
    global on
    on = False
    if _stack:
        end(_stack[0])
    totals = {NAMES[n]: (_count[n], _total[n], _self[n])
              for n in range(len(NAMES)) if _count[n]}
    rec = Recording(tuple(NAMES), _name, _t0, _t1, _parent, _run, _qid, totals)
    _clear()  # the columns now belong to ``rec``
    return rec


def _clear() -> None:
    global _runs, _name, _t0, _t1, _parent, _run, _qid
    _name, _t0, _t1, _parent, _run, _qid = (array("q") for _ in range(6))
    _stack.clear()
    _kids.clear()
    for tot in (_count, _total, _self):
        tot[:] = [0] * len(tot)
    _runs = -1


class Recording:
    """What the recorder kept between ``start`` and ``stop``: the columns of
    the events (``name`` ids into ``names``, ``t0``, ``t1``, ``parent``,
    ``run``, ``qid``) and ``totals``, name -> (count, total ns, self ns)."""

    def __init__(self, names, name, t0, t1, parent, run, qid, totals):
        self.names = names
        self.name, self.t0, self.t1 = name, t0, t1
        self.parent, self.run, self.qid = parent, run, qid
        self.totals = totals

    def __len__(self) -> int:
        return len(self.t0)

    def request(self, i: int) -> tuple[int, int] | int:
        """Span ``i``'s request id: (run, qid), or -1 where no query is known."""
        return (self.run[i], self.qid[i]) if self.qid[i] >= 0 else -1

    def depth(self) -> np.ndarray:
        """Each span's nesting depth (0 for a span with no parent)."""
        parent = np.frombuffer(self.parent, dtype=np.int64)
        depth = np.zeros(len(parent), dtype=np.int64)
        up = parent.copy()
        while (up >= 0).any():
            inner = up >= 0
            depth += inner
            up[inner] = parent[up[inner]]
        return depth

    def timeline(self) -> tuple[np.ndarray, list[str | None]]:
        """The spans as change points, sorted: (times in ns, labels), where
        from ``times[j]`` on the innermost span open is ``labels[j]`` (None
        where no span is open).  At one instant, closes come before opens,
        inner closes before outer, outer opens before inner."""
        n = len(self)
        name = np.frombuffer(self.name, dtype=np.int64)
        parent = np.frombuffer(self.parent, dtype=np.int64)
        depth = self.depth()
        times = np.concatenate([np.frombuffer(self.t0, dtype=np.int64),
                                np.frombuffer(self.t1, dtype=np.int64)])
        opening = np.concatenate([np.ones(n, np.int64), np.zeros(n, np.int64)])
        order_key = np.concatenate([depth, -depth])
        # a close leaves the parent's name (-1: none open)
        label = np.concatenate([name, np.where(parent >= 0, name[np.maximum(parent, 0)], -1)])
        order = np.lexsort((order_key, opening, times))
        names = self.names
        return times[order], [names[j] if j >= 0 else None for j in label[order].tolist()]
