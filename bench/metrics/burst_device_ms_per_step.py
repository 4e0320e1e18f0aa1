"""Device ms a step of the kernels launched inside `stage.external_burst`,
a collective's (its wait for a peer: `halo_device_ms_per_step`) left out."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    ns = [op.dur_ns for op in tr.ops
          if op.kernel and not op.comm
          and tr.in_range(op, "stage.external_burst")]
    return sum(ns) / 1e6 / tr.steps if ns else None
