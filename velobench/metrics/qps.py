"""Queries completed in the window over the window's whole length."""

UNIT, BETTER = "queries/s", "higher"


def read(run):
    return run.queries / run.window_s if run.window_s > 0 else None
