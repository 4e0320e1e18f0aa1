"""Find what `BENCHMARK.json` names: workloads, configurations, traffic
mixes, cells and the readers of the per-layer metrics, each in a file of
its own under this folder."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)}: no such file")
    return json.loads(path.read_text())


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(BENCH / "traffic" / f"{name}.json")


def cell(name: str) -> dict:
    return _json(BENCH / "cells" / f"{name}.json")


def metrics_of(workload_name: str, section: str) -> list:
    """The metrics of ``section`` (end_to_end or per_layer) that this
    workload reports: those without a ``workloads`` key, and those that
    list it."""
    return [m for m in benchmark()[section]
            if workload_name in m.get("workloads", [workload_name])]


def reader(metric: str):
    """The ``read(ctx)`` function of `metrics/<metric>.py`."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)}: no such file")
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
