"""Kernel launches a step issued inside the stepper's
`stage.external_burst` range (the external 2D burst, `core/dg2d.py`)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    n = sum(op.kernel and tr.in_range(op, "stage.external_burst")
            for op in tr.ops)
    return n / tr.steps if n else None
