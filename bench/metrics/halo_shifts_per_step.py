"""Ring shifts a step of the halo exchange on rank 0: the increase of the
program's `halo.ppermute` counter (`distributed/halo.py`) over the
untraced window, over its steps (its closed form is
`halo.shifts_per_step(ring offsets, exchange period, m_2d)`)."""


def read(ctx):
    halo = ctx.get("halo")
    if not halo or not halo["shifts"] or not ctx["steps"]:
        return None
    return halo["shifts"] / ctx["steps"]
