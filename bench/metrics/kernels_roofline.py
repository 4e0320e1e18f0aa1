"""The port's own step kernels' share of their roofline, in %: the sum of
each call's bound (the larger of its bytes over the HBM rate and its
operations over the peak, `bench/roofline.py`, from the cell's shapes)
over the sum of their device time.  Reads nothing unless the program's
launch counter shows exactly the calls `roofline.STEP_CALLS` costs."""
from bench import roofline


def read(ctx):
    tr, counts = ctx["trace"], ctx["launches"]
    if tr is None or not counts:
        return None
    want = {k: len(v) * tr.steps for k, v in roofline.STEP_CALLS.items()}
    if counts != want:
        return None
    ns = sum(op.dur_ns for op in tr.ops
             if op.kernel and roofline.is_own_kernel(op.name))
    if not ns:
        return None
    costs = roofline.step_costs(ctx["nl"], ctx["nt"], ctx["dtype"])
    bound = sum(roofline.bound_s(b, f, ctx["dtype"])
                for b, f in costs.values()) * tr.steps
    return 100.0 * bound / (ns / 1e9)
