"""Small sizes of the cells for the CPU tests: the configuration's mesh cut
to a few hundred triangles over the same cell size, and few layers."""
from __future__ import annotations

import time

import torch

from bench import harness, spec

CPU = torch.device("cpu")


def mesh(workload: str, nx: int = 8) -> dict:
    m = dict(spec.config(spec.workload(workload)["config"])["mesh"])
    scale = nx / m["nx"]
    m.update(nx=nx, ny=nx // 2, lx=m["lx"] * scale, ly=m["ly"] * scale)
    return m


def overrides(workload: str, nx: int = 8, nl: int = 3) -> dict:
    return {"mesh": mesh(workload, nx), "nl": nl}


def run(workload: str, seed: int = 11, seconds: float = 0.2,
        traced: bool = False, port=None, **kw) -> dict:
    """One run of ``workload`` on the CPU at the small size."""
    return harness.run_cell(workload, seed, seconds, traced, CPU,
                            time.perf_counter(), overrides(workload, **kw),
                            port=port)
