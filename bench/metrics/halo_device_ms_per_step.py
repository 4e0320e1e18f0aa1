"""Device ms a step of the kernels launched inside the program's
`halo.exchange` ranges on rank 0 (`distributed/halo.py`: packing, the
NCCL send/receive kernels with their wait for the peer, unpacking)."""
import bisect


def read(ctx):
    tr = ctx["trace"]
    spans = sorted(tr.ranges.get("halo.exchange", ())) if tr else []
    if not spans:
        return None
    starts = [a for a, _ in spans]
    ns = 0
    for op in tr.ops:
        i = bisect.bisect_right(starts, op.launched_ns) - 1
        if op.kernel and i >= 0 and op.launched_ns <= spans[i][1]:
            ns += op.dur_ns
    return ns / 1e6 / tr.steps if ns else None
