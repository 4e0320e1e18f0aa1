"""Small sizes of the cells for the CPU tests: the configuration's mesh cut
to a few dozen triangles over the same cell size, and few layers; a cell
of several chips runs as its ranks over gloo."""
from __future__ import annotations

import time

import torch

from bench import harness, ranks, spec

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
    """One run of ``workload`` on the CPU at the small size: a cell of
    several chips as its ranks over gloo."""
    if spec.workload(workload)["chips"] > 1 and port is None:
        return run_ranks(workload, seed=seed, seconds=seconds,
                         traced=traced, **kw)
    return harness.run_cell(workload, seed, seconds, traced, CPU,
                            time.perf_counter(), overrides(workload, **kw),
                            port=port)


def run_ranks(workload: str, n_ranks: int = None, patch=None,
              seed: int = 11, seconds: float = 0.2, traced: bool = False,
              deadline_s: float = 300.0, min_steps: int = 3, **kw) -> dict:
    """One run of ``workload`` as ``n_ranks`` ranks (default: its chips)
    over gloo on the CPU at the small size."""
    n_ranks = n_ranks or spec.workload(workload)["chips"]
    return ranks.run_cell(workload, seed, seconds, traced, n_ranks,
                          time.perf_counter(), placement="cpu",
                          deadline_s=deadline_s,
                          overrides=overrides(workload, **kw), patch=patch,
                          min_steps=min_steps)
