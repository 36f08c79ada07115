"""Host time of the engine, the search coroutines and the pool per query:
the wall time of the window's ``System.run`` calls less the time inside the
distance plane's methods (the harness's spans around both)."""

UNIT, BETTER = "ms/query", "lower"


def read(run):
    if not run.queries or "engine" not in run.spans_s:
        return None
    dist = sum(v for k, v in run.spans_s.items() if k.startswith("distance."))
    return (run.spans_s["engine"] - dist) / run.queries * 1e3
