"""Kernels on the card per call in the traced window (the profiler's kernel
count: copies and fills left out, over the window's calls)."""

from velobench.trace import is_copy

UNIT, BETTER = "launches/call", "lower"


def read(run):
    if run.trace is None or not run.calls:
        return None
    n = sum(rec[0] for name, rec in run.trace["ops"].items() if not is_copy(name))
    return n / run.calls if n else None
