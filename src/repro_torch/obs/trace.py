"""Staged tracing: named spans that a profiler timeline or the program's own
recorder can see, and an opt-in ``torch.profiler`` session that lands in a
run directory.

``annotate(name)`` is the one span API.  It keeps one stack of open spans:
``open_ranges()`` names them, outermost first, whether or not anything is
recorded (the dry runs, `launch/ocean_dryrun.py` and `launch/lm_dryrun.py`,
tag each op's bytes by them).

* **Off** (the default): a span pushes and pops its name, and opens a
  ``torch.profiler.record_function`` range only while a profiler is active
  (``torch._C._autograd._profiler_enabled()``), so the stepper's stages
  (``imex.stage1``, ``stage.*``), the ops' dispatches
  (``kops.<op>.<backend>``) and the diagnostics (``obs.diagnostics``)
  reach a profiler's trace as they always did, and cost nothing else when
  none is attached.  ``python -m repro_torch.profile_step`` sums device time
  per range.
* **Recording** (inside ``recording()``): each span also appends
  ``(name, start_ns, end_ns, parent, step, syncs)`` to an in-memory list,
  read with ``time.perf_counter_ns()``; ``parent`` is the index of the
  enclosing recorded span (-1 for a root) and ``step`` the index of the
  root, so the spans of one ``ocean.step`` share it.  Spans that reach the
  profiler also open an NVTX range of their name once CUDA is initialised,
  for external timeline tools.  On a CUDA machine, ``recording()`` sets
  ``torch.cuda.set_sync_debug_mode("warn")`` and counts every "called a
  synchronizing CUDA operation" warning (each one, with no once-per-
  location filter) against the innermost open span; ``sync_counts()`` sums
  them by name.
* **The clock.** ``recording()`` stores one anchor pair (``time.time_ns()``,
  ``time.perf_counter_ns()``); ``spans()`` and ``drain()`` return the spans
  shifted through it onto the wall clock, which is the clock of
  ``torch.profiler``'s host and device events (``start_ns()`` of
  ``prof.profiler.kineto_results.events()``), so a profiled step's idle
  gaps and launches can be put down to the innermost span open on the host.
  ``self_ns(spans)`` is a span's duration less what its children cover.

Spans opened with ``profiler=False`` are the recorder's alone: they open
no ``record_function`` and no NVTX range, and put nothing on a profiler's
timeline.  Their names never start with ``stage.``, ``imex.``, ``kops.``
or ``obs.``: the benchmark's trace reader (`bench/trace.py`) drops device
events of those prefixes as the profiler's copies of the ranges, treats
``stage.*`` ranges as never nested, and the ocean dry run maps each
``kops.*`` name to its kernel.

**Counters.** ``count(name)`` adds one to a named counter and ``counts()``
reads them all, recording or not: ``burst.eager``, ``burst.capture`` and
``burst.replay`` say how each external burst ran (`core/dg2d.py`
``run_external``: the host's loop, a CUDA graph's capture, its replay).

``trace_session`` wraps ``torch.profiler.profile`` and writes a Chrome
trace (``trace.json``) into the run directory.  It is opt-in: enabled
explicitly, or via the ``REPRO_TRACE=1`` environment variable (run
directory override: ``REPRO_RUN_DIR``).
"""
from __future__ import annotations

import contextlib
import datetime
import os
import time
import warnings
from typing import Iterator, NamedTuple, Optional

import torch

ENV_TRACE = "REPRO_TRACE"
ENV_RUN_DIR = "REPRO_RUN_DIR"
DEFAULT_RUNS_ROOT = "runs"
TRACE_FILE = "trace.json"
# the text of PyTorch's warning in sync debug mode "warn"
SYNC_WARNING = "called a synchronizing CUDA operation"
# where a sync counts when no recorded span is open
NO_SPAN = "(no span)"

_profiler_enabled = torch._C._autograd._profiler_enabled
_clock = time.perf_counter_ns
# named counts since the process started, kept whether or not anything
# records (``count``, ``counts``)
_COUNTS: dict = {}


class Span(NamedTuple):
    """One recorded span, on the profiler's clock (ns); ``end_ns`` is None
    while the span is open."""
    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    step: int
    syncs: int


class _Recorder:
    def __init__(self):
        # one list a span: [name, start, end, parent, step, syncs, index]
        self.records: list = []
        self.loose: dict = {}      # syncs with no recorded span open
        self.offset_ns = 0         # wall clock - perf_counter


# the open spans, outermost first; the recorder, and whether it records
_STACK: list = []
_RECORDER = _Recorder()
_ON = False


class annotate:
    """A span named ``name`` over the enclosed block (see the module
    docstring); ``profiler=False`` keeps it from the profiler."""
    __slots__ = ("name", "profiler", "_rf", "_rec", "_nvtx")

    def __init__(self, name: str, profiler: bool = True):
        self.name = name
        self.profiler = profiler

    def __enter__(self):
        self._rf = self._rec = None
        if _ON:
            self._open_recorded()
        elif self.profiler and _profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        _STACK.append(self)
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is not None:
            rec[2] = _clock()
            if self._nvtx:
                torch.cuda.nvtx.range_pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _STACK.pop()
        return False

    def _open_recorded(self):
        if self.profiler and _profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        start = _clock()          # next to the profiler's own stamp
        # pop only what was pushed: CUDA may initialise inside the span
        self._nvtx = self.profiler and torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        parent = _STACK[-1]._rec if _STACK else None
        records = _RECORDER.records
        i = len(records)
        if parent is None:
            rec = [self.name, start, None, -1, i, 0, i]
        else:
            rec = [self.name, start, None, parent[6], parent[4], 0, i]
        records.append(rec)
        self._rec = rec


def count(name: str) -> None:
    """One more of the event ``name`` (``counts()`` reads it; no profiler
    or recording needed)."""
    _COUNTS[name] = _COUNTS.get(name, 0) + 1


def counts() -> dict:
    """{counter name: events since the process started}."""
    return dict(_COUNTS)


def open_ranges() -> tuple:
    """The names of the `annotate` spans open now, outermost first."""
    return tuple(s.name for s in _STACK)


def _count_sync(show):
    """A ``warnings.showwarning`` that counts PyTorch's sync warnings
    against the innermost open span and hands every other to ``show``."""
    def hook(message, category, filename, lineno, file=None, line=None):
        if not str(message).startswith(SYNC_WARNING):
            return show(message, category, filename, lineno, file, line)
        rec = _STACK[-1]._rec if _STACK else None
        if rec is not None:
            rec[5] += 1
        else:
            name = _STACK[-1].name if _STACK else NO_SPAN
            loose = _RECORDER.loose
            loose[name] = loose.get(name, 0) + 1
    return hook


def _anchor(tries: int = 5) -> int:
    """wall clock - perf_counter, from the tightest of ``tries`` readings
    of the wall clock between two of the perf counter (a reading the OS
    interrupts is wide, and loses)."""
    best = None
    for _ in range(tries):
        p0 = _clock()
        wall = time.time_ns()
        p1 = _clock()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, wall - (p0 + p1) // 2)
    return best[1]


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record every span opened inside, and count the host's syncs by the
    innermost open span (on a CUDA machine); read them with ``spans()``,
    ``sync_counts()`` or ``drain()``.  Not reentrant."""
    global _ON
    if _ON:
        raise RuntimeError("trace.recording() is already on")
    _RECORDER.offset_ns = _anchor()
    cuda = torch.cuda.is_available()
    mode = torch.cuda.get_sync_debug_mode() if cuda else 0
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.showwarning = _count_sync(warnings.showwarning)
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        _ON = True
        try:
            yield
        finally:
            _ON = False
            if cuda:
                torch.cuda.set_sync_debug_mode(mode)


def spans() -> list:
    """The recorded spans, in the order they opened, on the profiler's
    clock (`Span`)."""
    off = _RECORDER.offset_ns
    return [Span(r[0], r[1] + off, None if r[2] is None else r[2] + off,
                 r[3], r[4], r[5]) for r in _RECORDER.records]


def sync_counts() -> dict:
    """{span name: syncs counted while it was the innermost open span}."""
    out = dict(_RECORDER.loose)
    for r in _RECORDER.records:
        if r[5]:
            out[r[0]] = out.get(r[0], 0) + r[5]
    return out


def drain() -> list:
    """``spans()``, then forget them and their sync counts (between
    steps: a span still open keeps its old parent and step indices)."""
    out = spans()
    _RECORDER.records = []
    _RECORDER.loose = {}
    return out


def self_ns(spans_: list) -> list:
    """Each span's self time: its duration less the part of it that its
    children's intervals cover (ns; 0 for a span still open)."""
    cover = [[] for _ in spans_]
    for s in spans_:
        if s.parent >= 0 and s.end_ns is not None:
            cover[s.parent].append((s.start_ns, s.end_ns))
    out = []
    for s, kids in zip(spans_, cover):
        if s.end_ns is None:
            out.append(0)
            continue
        covered, reach = 0, s.start_ns
        for a, b in sorted(kids):
            a, b = max(a, reach), min(b, s.end_ns)
            if b > a:
                covered += b - a
                reach = b
        out.append(s.end_ns - s.start_ns - covered)
    return out


def trace_enabled() -> bool:
    return os.environ.get(ENV_TRACE, "0") not in ("", "0", "false", "False")


def default_run_dir(prefix: str = "trace") -> str:
    env = os.environ.get(ENV_RUN_DIR)
    if env:
        return env
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    return os.path.join(DEFAULT_RUNS_ROOT, f"{prefix}-{stamp}-{os.getpid()}")


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
