"""The sorts' share of the device time in the traced window: operations
whose name holds one of ``PATTERNS`` (case ignored: cub's radix sorts,
PyTorch's sort helpers that fill the index lists) over every device operation's time."""

UNIT, BETTER = "fraction", "lower"
PATTERNS = ("sort", "fill_index_and_segment", "fill_reverse_indices")


def read(run):
    if run.trace is None:
        return None
    ops = run.trace["ops"]
    total = sum(rec[1] for rec in ops.values())
    sort = sum(rec[1] for name, rec in ops.items()
               if any(p in name.lower() for p in PATTERNS))
    return sort / total if total > 0 else None
