"""The inner-product ``scan_select`` kernel's share of its roofline in the
traced window, in %: the sum of each launch's least time
(``velobench/roofline_select.py``: its bytes at the HBM rate) over the sum
of the device time of the kernels named ``KERNEL``.  Nothing is read when
the traced launches do not match the shapes the driver reports."""

from velobench import roofline_select

UNIT, BETTER = "%", "higher"
KERNEL = "scan_select_ip_kernel"


def read(run):
    shapes = run.launch_shapes.get("scan_select")
    if run.trace is None or not shapes:
        return None
    recs = [rec for name, rec in run.trace["ops"].items() if KERNEL in name]
    launches, seconds = sum(r[0] for r in recs), sum(r[1] for r in recs)
    if launches != len(shapes) * run.calls or seconds <= 0:
        return None
    bound = sum(roofline_select.scan_select_bound_s(*s) for s in shapes) * run.calls
    return 100.0 * bound / seconds
