"""Launches of ``binary_ip`` and ``int4_dist`` per query in the window (the
kernel modules' ``launches`` counters)."""

UNIT, BETTER = "launches/query", "lower"


def read(run):
    c = run.counters
    if not run.queries or "binary_ip.launches" not in c:
        return None
    return (c["binary_ip.launches"] + c.get("int4_dist.launches", 0)) / run.queries
