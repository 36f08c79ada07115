"""Page reads of the modelled SSD per query (``WorkloadStats.io_count``).
The SSD is a model: a read costs the host its decode, not a wait on a
device."""

UNIT, BETTER = "reads/query", "lower"


def read(run):
    io = run.counters.get("io_count")
    return io / run.queries if io is not None and run.queries else None
