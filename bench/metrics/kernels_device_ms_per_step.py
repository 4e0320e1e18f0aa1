"""Device ms a step of the port's own step kernels, K1-K4 and K7
(`csrc/ocean_kernels.cu` through `kernels/ops.py`)."""
from bench.roofline import is_own_kernel


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    ns = [op.dur_ns for op in tr.ops if op.kernel and is_own_kernel(op.name)]
    return sum(ns) / 1e6 / tr.steps if ns else None
