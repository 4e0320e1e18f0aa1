"""Megabytes (10^6 bytes) a step that rank 0 sends in its halo exchanges:
the increase of the program's `halo.bytes` counter (`distributed/halo.py`)
over the untraced window, over its steps."""


def read(ctx):
    halo = ctx.get("halo")
    if not halo or not halo["bytes"] or not ctx["steps"]:
        return None
    return halo["bytes"] / 1e6 / ctx["steps"]
