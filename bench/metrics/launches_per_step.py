"""CUDA kernel launches a step: the kernels the traced steps ran on the
device, over the traced steps."""


def read(ctx):
    tr = ctx["trace"]
    n = sum(op.kernel for op in tr.ops) if tr else 0
    return n / tr.steps if n else None
