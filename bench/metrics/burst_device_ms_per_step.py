"""Device ms a step of the kernels launched inside `stage.external_burst`."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    ns = [op.dur_ns for op in tr.ops
          if op.kernel and tr.in_range(op, "stage.external_burst")]
    return sum(ns) / 1e6 / tr.steps if ns else None
