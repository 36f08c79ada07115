"""The (query row, chunk) pairs per call in the window that took
``scan_select``'s full radix select rather than its filter (the kernel's
device counter ``full_select_rows``, read at each end of the window).  A
row's first chunk always does; more mean a carry that the chunks' estimates
keep beating, which out-of-distribution queries and the per-row ``cr`` of
inner product may cause."""

UNIT, BETTER = "rows/call", "lower"


def read(run):
    rows = run.counters.get("scan_select.full_select_rows")
    if rows is None or not run.calls:
        return None
    return rows / run.calls
