"""The record pool's hits over its accesses in the window, from the
engine's ``WorkloadStats.cache_hits`` and ``cache_misses``."""

UNIT, BETTER = "fraction", "higher"


def read(run):
    hits, misses = run.counters.get("cache_hits"), run.counters.get("cache_misses")
    if hits is None or hits + misses == 0:
        return None
    return hits / (hits + misses)
