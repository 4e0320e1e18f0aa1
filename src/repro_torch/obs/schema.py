"""Schema for the flight-recorder JSONL metrics stream.

One JSON object per line.  Every record has:

  ts      float   unix seconds (host clock at emission)
  kind    str     one of KINDS
  name    str     dotted metric name, e.g. "kernel_dispatch", "obs.cfl_2d"
  value           kind-dependent payload (see below)
  labels  dict    optional {str: str|int|float|bool} dimensions
  step    int     optional simulation/train step the record belongs to

Per-kind ``value``:

  counter      number >= 0 (cumulative; emitted as a snapshot by flush())
  gauge        number or null (null = value was non-finite on device)
  histogram    {"count": int, "sum": num, "min": num, "max": num,
                "p50": num, "p90": num}   — units in the name (..._us, ...)
  event        any JSON object (free-form, e.g. monitor violations)
  diagnostics  {str: number|bool|null} — the physics Diagnostics snapshot

Non-finite floats are sanitised to null by the sink (strict JSON) — the
physics NaN signal travels as the explicit ``nonfinite`` bool inside
diagnostics records, never as a bare NaN literal.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Iterable, List, Tuple

KINDS = ("counter", "gauge", "histogram", "event", "diagnostics")

HIST_KEYS = ("count", "sum", "min", "max", "p50", "p90")


class SchemaError(ValueError):
    """A metrics record does not conform to the flight-recorder schema."""


def _is_num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _check_labels(labels) -> None:
    if not isinstance(labels, dict):
        raise SchemaError(f"labels must be a dict, got {type(labels).__name__}")
    for k, v in labels.items():
        if not isinstance(k, str):
            raise SchemaError(f"label key {k!r} is not a string")
        if not isinstance(v, (str, int, float, bool)):
            raise SchemaError(f"label {k!r} has non-scalar value {v!r}")


def validate_record(rec: Any) -> None:
    """Raise SchemaError if ``rec`` is not a valid flight-recorder record."""
    if not isinstance(rec, dict):
        raise SchemaError(f"record must be an object, got {type(rec).__name__}")
    for req in ("ts", "kind", "name"):
        if req not in rec:
            raise SchemaError(f"missing required field {req!r}")
    if not _is_num(rec["ts"]):
        raise SchemaError(f"ts must be a number, got {rec['ts']!r}")
    kind = rec["kind"]
    if kind not in KINDS:
        raise SchemaError(f"kind must be one of {KINDS}, got {kind!r}")
    name = rec["name"]
    if not isinstance(name, str) or not name:
        raise SchemaError(f"name must be a non-empty string, got {name!r}")
    if "labels" in rec:
        _check_labels(rec["labels"])
    if "step" in rec and rec["step"] is not None \
            and not isinstance(rec["step"], int):
        raise SchemaError(f"step must be an int, got {rec['step']!r}")

    v = rec.get("value")
    if kind == "counter":
        if not _is_num(v) or v < 0:
            raise SchemaError(f"counter value must be a number >= 0, got {v!r}")
    elif kind == "gauge":
        if v is not None and not _is_num(v):
            raise SchemaError(f"gauge value must be a number or null, got {v!r}")
    elif kind == "histogram":
        if not isinstance(v, dict):
            raise SchemaError(f"histogram value must be an object, got {v!r}")
        for k in HIST_KEYS:
            if k not in v:
                raise SchemaError(f"histogram value missing key {k!r}")
            if not _is_num(v[k]):
                raise SchemaError(f"histogram {k!r} must be a number, "
                                  f"got {v[k]!r}")
        if v["count"] < 0 or v["min"] > v["max"]:
            raise SchemaError(f"histogram value inconsistent: {v!r}")
    elif kind == "event":
        if v is not None and not isinstance(v, dict):
            raise SchemaError(f"event value must be an object or null, "
                              f"got {v!r}")
    elif kind == "diagnostics":
        if not isinstance(v, dict):
            raise SchemaError(f"diagnostics value must be an object, "
                              f"got {v!r}")
        for k, x in v.items():
            if not isinstance(k, str):
                raise SchemaError(f"diagnostics key {k!r} is not a string")
            if x is not None and not isinstance(x, (int, float, bool)):
                raise SchemaError(f"diagnostics {k!r} has non-scalar value "
                                  f"{x!r}")


def sanitize(obj: Any) -> Any:
    """Recursively replace non-finite floats with None (strict JSON)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    return obj


def validate_lines(lines: Iterable[str]) -> Tuple[int, List[Tuple[int, str]]]:
    """Validate an iterable of JSONL lines.

    Returns (n_valid_records, [(lineno, error), ...]); blank lines are
    skipped.  Parsing is strict JSON (NaN/Infinity literals are errors —
    the sink sanitises them to null at write time)."""
    n_ok = 0
    errors: List[Tuple[int, str]] = []
    for i, line in enumerate(lines, start=1):
        s = line.strip()
        if not s:
            continue
        try:
            rec = json.loads(
                s, parse_constant=lambda c: (_ for _ in ()).throw(
                    SchemaError(f"non-strict JSON literal {c!r}")))
            validate_record(rec)
        except (json.JSONDecodeError, SchemaError) as e:
            errors.append((i, str(e)))
            continue
        n_ok += 1
    return n_ok, errors


def validate_file(path: str) -> Tuple[int, List[Tuple[int, str]]]:
    """Validate a JSONL metrics file; see validate_lines."""
    with open(path) as fh:
        return validate_lines(fh)
