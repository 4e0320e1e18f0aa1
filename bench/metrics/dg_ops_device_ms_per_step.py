"""Device ms a step of PyTorch's own kernels outside the external burst:
the DG operators of `core/{dg3d,horizontal,vertical,turbulence,eos}.py`
(every kernel but the port's own, K1-K4 and K7, the burst's, and a
collective's, whose wait for a peer `halo_device_ms_per_step` reads)."""
from bench.roofline import is_own_kernel


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    ns = [op.dur_ns for op in tr.ops
          if op.kernel and not op.comm and not is_own_kernel(op.name)
          and not tr.in_range(op, "stage.external_burst")]
    return sum(ns) / 1e6 / tr.steps if ns else None
