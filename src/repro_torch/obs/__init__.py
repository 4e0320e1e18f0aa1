"""Flight recorder: staged tracing, physics monitors, metrics.

Layering: ``metrics``/``schema``/``trace`` do not depend on the model code
(the kernel layer imports them for dispatch counting), while
``diagnostics`` sits on top of ``core``, so it is loaded lazily here to
keep ``import repro_torch.obs.metrics`` cycle-free from inside
``kernels/ops.py``.
"""
from __future__ import annotations

from . import metrics, schema, trace                        # noqa: F401

_LAZY = ("diagnostics",)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["metrics", "schema", "trace", "diagnostics"]
