"""Flight-recorder metrics: counters / gauges / histograms + a JSONL sink.

A ``Registry`` owns named instruments and (optionally) a ``JsonlSink``:

    reg = metrics.Registry(sink=metrics.JsonlSink(path))
    reg.counter("kernel_dispatch", op="solve_r", backend="cuda").inc()
    reg.gauge("runner.step_time_ema_s").set(0.12)
    with reg.timer("stage_time_us", stage="step"):
        ...                         # host wall time -> histogram observe
    reg.event("monitor.violation", {"rule": "cfl"}, step=3)   # immediate
    reg.diagnostics("physics", diag_dict, step=3)             # immediate
    reg.flush(step=3)               # snapshot counters/gauges/histograms

The port runs eagerly, so the kernel dispatch counter of ``kernels/ops.py``
counts every call: one per kernel launch on the cuda backend, the quantity
a launch-latency model multiplies by the per-launch overhead (paper §3.3).
The JAX package's counter counts call sites traced into each compiled
program instead; the record schema is the same.

The module-level default registry is what the instrumented library paths
write to; ``configure(path)`` attaches a sink (until then instruments
aggregate in memory and flush() is a no-op), ``reset()`` clears it (tests).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

from . import schema

# bounded per-histogram sample reservoir (most-recent samples win)
_HIST_CAP = 4096


class JsonlSink:
    """Append-only JSONL writer (thread-safe, line-buffered)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._fh = open(path, "a", buffering=1)

    def write(self, rec: Dict[str, Any]) -> None:
        line = json.dumps(schema.sanitize(rec), allow_nan=False,
                          separators=(",", ":"))
        with self._lock:
            self._fh.write(line + "\n")

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()


class Counter:
    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    def __init__(self):
        self._v: Optional[float] = None

    def set(self, v: float) -> None:
        self._v = float(v)

    @property
    def value(self) -> Optional[float]:
        return self._v


class Histogram:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._samples = []

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            if len(self._samples) >= _HIST_CAP:
                self._samples.pop(0)
            self._samples.append(v)

    def _quantile(self, q: float) -> float:
        s = sorted(self._samples)
        if not s:
            return 0.0
        i = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
        return s[i]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            if self.count == 0:
                return dict(count=0, sum=0.0, min=0.0, max=0.0,
                            p50=0.0, p90=0.0)
            return dict(count=self.count, sum=self.sum, min=self.min,
                        max=self.max, p50=self._quantile(0.5),
                        p90=self._quantile(0.9))


def _key(name: str, labels: Dict[str, Any]) -> Tuple:
    return (name,) + tuple(sorted(labels.items()))


class _Timer:
    def __init__(self, hist: Histogram, scale: float):
        self._hist = hist
        self._scale = scale

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe((time.perf_counter() - self._t0) * self._scale)
        return False


class Registry:
    """Named instruments + immediate-mode events over one optional sink."""

    def __init__(self, sink: Optional[JsonlSink] = None):
        self.sink = sink
        self._lock = threading.Lock()
        self._counters: Dict[Tuple, Tuple[Counter, str, dict]] = {}
        self._gauges: Dict[Tuple, Tuple[Gauge, str, dict]] = {}
        self._hists: Dict[Tuple, Tuple[Histogram, str, dict]] = {}

    def _get(self, store, cls, name: str, labels: dict):
        k = _key(name, labels)
        with self._lock:
            if k not in store:
                store[k] = (cls(), name, dict(labels))
            return store[k][0]

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(self._hists, Histogram, name, labels)

    def timer(self, name: str, scale: float = 1e6, **labels) -> _Timer:
        """Context manager: host wall time -> histogram observe.

        Default scale 1e6 = microseconds (name the metric ``*_us``)."""
        return _Timer(self.histogram(name, **labels), scale)

    # -- immediate-mode records ----------------------------------------------
    def _write(self, rec: Dict[str, Any]) -> None:
        if self.sink is not None:
            self.sink.write(rec)

    def _rec(self, kind: str, name: str, value, labels: dict,
             step: Optional[int]) -> Dict[str, Any]:
        rec: Dict[str, Any] = dict(ts=time.time(), kind=kind, name=name,
                                   value=value)
        if labels:
            rec["labels"] = labels
        if step is not None:
            rec["step"] = int(step)
        return rec

    def event(self, name: str, value: Optional[dict] = None,
              step: Optional[int] = None, **labels) -> None:
        self._write(self._rec("event", name, value, labels, step))

    def diagnostics(self, name: str, values: Dict[str, Any],
                    step: Optional[int] = None, **labels) -> None:
        self._write(self._rec("diagnostics", name, values, labels, step))

    # -- snapshots ------------------------------------------------------------
    def flush(self, step: Optional[int] = None) -> None:
        """Write one snapshot record per instrument to the sink."""
        if self.sink is None:
            return
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._hists.values())
        for c, name, labels in counters:
            self._write(self._rec("counter", name, c.value, labels, step))
        for g, name, labels in gauges:
            if g.value is not None:
                self._write(self._rec("gauge", name, g.value, labels, step))
        for h, name, labels in hists:
            if h.count:
                self._write(self._rec("histogram", name, h.snapshot(),
                                      labels, step))

    def snapshot(self) -> Dict[str, Any]:
        """In-memory view {kind: {name{labels}: value}} (tests/CLIs)."""
        def fmt(name, labels):
            if not labels:
                return name
            return name + "{" + ",".join(f"{k}={v}" for k, v in
                                         sorted(labels.items())) + "}"
        out: Dict[str, Any] = {"counter": {}, "gauge": {}, "histogram": {}}
        with self._lock:
            for c, name, labels in self._counters.values():
                out["counter"][fmt(name, labels)] = c.value
            for g, name, labels in self._gauges.values():
                out["gauge"][fmt(name, labels)] = g.value
            for h, name, labels in self._hists.values():
                out["histogram"][fmt(name, labels)] = h.snapshot()
        return out

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()


# --------------------------------------------------------------------------
# module-level default registry (what the instrumented library writes to)
# --------------------------------------------------------------------------
_default = Registry()


def default() -> Registry:
    return _default


def configure(path: Optional[str] = None) -> Registry:
    """Attach a JSONL sink at ``path`` to the default registry (keeps the
    accumulated in-memory instruments). ``path=None`` detaches the sink."""
    if _default.sink is not None:
        _default.sink.close()
    _default.sink = JsonlSink(path) if path else None
    return _default


def reset() -> Registry:
    """Drop all instruments and the sink of the default registry (tests)."""
    global _default
    if _default.sink is not None:
        _default.sink.close()
    _default = Registry()
    return _default
