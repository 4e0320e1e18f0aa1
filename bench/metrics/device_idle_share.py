"""The device's idle share of the traced steps, in %: one minus the union
of the device activities' intervals, a collective's kernels left out (they
wait for a peer), over the traced steps' wall time."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_ns() / 1e9 / tr.window_s)
