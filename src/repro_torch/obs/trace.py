"""Staged tracing: named ranges for profiler timelines, and an opt-in
``torch.profiler`` session that lands in a run directory.

``annotate(name)`` opens a ``torch.profiler.record_function`` range, which
an active profiler records as a host event enclosing the operators (and so
the device kernels) launched inside it, plus an NVTX range when CUDA is
initialised, for external timeline tools.  The stepper's stages
(``imex.stage1``, ``stage.*``), the ops' dispatches (``kops.<op>.<backend>``)
and the diagnostics (``obs.diagnostics``) are wrapped in it;
``python -m repro_torch.profile_step`` sums device time per range.
``open_ranges()`` names the ranges open now, outermost first (the dry
run, `launch/ocean_dryrun.py`, tags each op's bytes by them).

``trace_session`` wraps ``torch.profiler.profile`` and writes a Chrome
trace (``trace.json``) into the run directory.  It is opt-in: enabled
explicitly, or via the ``REPRO_TRACE=1`` environment variable (run
directory override: ``REPRO_RUN_DIR``).
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Iterator, Optional

import torch

ENV_TRACE = "REPRO_TRACE"
ENV_RUN_DIR = "REPRO_RUN_DIR"
DEFAULT_RUNS_ROOT = "runs"
TRACE_FILE = "trace.json"

# the names of the ranges open now, outermost first
_OPEN: list = []


def trace_enabled() -> bool:
    return os.environ.get(ENV_TRACE, "0") not in ("", "0", "false", "False")


def default_run_dir(prefix: str = "trace") -> str:
    env = os.environ.get(ENV_RUN_DIR)
    if env:
        return env
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    return os.path.join(DEFAULT_RUNS_ROOT, f"{prefix}-{stamp}-{os.getpid()}")


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A profiler range (record_function) and, once CUDA is initialised, an
    NVTX range of the same name."""
    _OPEN.append(name)
    try:
        with torch.profiler.record_function(name):
            if torch.cuda.is_initialized():
                with torch.cuda.nvtx.range(name):
                    yield
            else:
                yield
    finally:
        _OPEN.pop()


def open_ranges() -> tuple:
    """The names of the `annotate` ranges open now, outermost first."""
    return tuple(_OPEN)


@contextlib.contextmanager
def trace_session(run_dir: Optional[str] = None,
                  enabled: Optional[bool] = None) -> Iterator[Optional[str]]:
    """Opt-in profiler trace over the enclosed block.

    Yields the run directory when tracing is active, else None.  ``enabled``
    defaults to the REPRO_TRACE environment toggle, so harnesses can wrap
    their hot section unconditionally and let the environment decide.  The
    trace covers the host and, when a card is present, the device."""
    if enabled is None:
        enabled = trace_enabled()
    if not enabled:
        yield None
        return
    run_dir = run_dir or default_run_dir()
    os.makedirs(run_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield run_dir
    prof.export_chrome_trace(os.path.join(run_dir, TRACE_FILE))
