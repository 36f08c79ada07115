"""Host wall time inside the distance plane's methods (``system.ctx.dist``,
each wrapped in a span by the harness) per query: the wrappers, the host
copies, the kernels and the waits for them."""

UNIT, BETTER = "ms/query", "lower"


def read(run):
    spans = [v for k, v in run.spans_s.items() if k.startswith("distance.")]
    if not run.queries or not spans:
        return None
    return sum(spans) / run.queries * 1e3
