"""``binary_ip``'s share of its roofline in the traced window, in %: the sum
of each launch's least time (``velobench/roofline.py``: operations at the
bf16 tensor-core peak or bytes at the HBM rate, whichever is longer) over
the sum of the device time of its kernels (``KERNELS``).  Nothing is read
when the traced launches do not match the shapes the driver reports."""

from velobench import roofline

UNIT, BETTER = "%", "higher"
KERNELS = ("binary_mma_kernel", "binary_lanes_kernel")


def read(run):
    shapes = run.launch_shapes.get("binary_ip")
    if run.trace is None or not shapes:
        return None
    recs = [rec for name, rec in run.trace["ops"].items() if any(k in name for k in KERNELS)]
    launches, seconds = sum(r[0] for r in recs), sum(r[1] for r in recs)
    if launches != len(shapes) * run.calls or seconds <= 0:
        return None
    bound = sum(roofline.binary_ip_bound_s(B, N, d) for B, N, d in shapes) * run.calls
    return 100.0 * bound / seconds
