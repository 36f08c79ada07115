"""Rows per call of the distance plane's quantized levels in the window
(``DistanceStats``: level-1 and level-2 rows over their calls)."""

UNIT, BETTER = "rows/call", "higher"


def read(run):
    c = run.counters
    calls = c.get("distance.level1_calls", 0) + c.get("distance.level2_calls", 0)
    rows = c.get("distance.level1_rows", 0) + c.get("distance.level2_rows", 0)
    return rows / calls if calls else None
