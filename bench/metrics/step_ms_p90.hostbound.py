"""The 90th percentile of the untraced window's step times (CUDA events at
the step boundaries), where the card idles more than half its window: the
host paces the steps there, so the tail swings with the host's speed and
is read beside the rate, not bounded."""
from bench.harness import p90


def read(ctx):
    return p90(ctx["step_ms"]) if ctx["step_ms"] else None
