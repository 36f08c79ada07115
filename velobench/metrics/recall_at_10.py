"""Recall@10 of every query in the window against the reference's exact
top-10 (float32 on the card, TF32 off)."""

UNIT, BETTER = "fraction", "higher"


def read(run):
    return run.recall if run.queries else None
