"""Seconds from the process's start to the first timed call: data, index
build or load, encoding, upload, kernel build or load, warm-up."""

UNIT, BETTER = "s", "lower"


def read(run):
    return run.setup_s
