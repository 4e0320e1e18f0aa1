"""Ocean-model cells of the multi-rank runs (the paper's own workload).

Two configurations, those of the JAX package's `launch/ocean_dryrun.py`:
  * benchmark: the paper's timeline/benchmark mesh class — 210k triangles,
    32 sigma layers (Fig. 2 caption), m=20 external sub-steps;
  * gbr: Great-Barrier-Reef scale — 3.3M triangles (paper §5), 20 layers
    (paper: 10-29 variable; sigma grid uses the mean), reef-belt bathymetry;
and the communication-avoiding variant of the benchmark.

`build_cell` builds one rank's `DistributedOcean` of a cell.  The JAX
package's `lower_ocean` lowers and compiles the sharded step with XLA and
reads its per-device memory and cost analysis; the port has no compiler to
ask, so its counterpart (per-rank memory and a roofline from the port's own
byte and flop accounting) belongs with the roofline and benchmark work and
is not here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import geometry, mesh2d, stepper
from ..distributed.halo import Transport
from ..distributed.ocean import DistributedOcean


@dataclasses.dataclass(frozen=True)
class OceanCell:
    name: str
    nx: int
    ny: int
    lx: float
    ly: float
    nl: int
    m_2d: int
    dt: float
    depth: float
    reef: bool = False
    halo_exchange_period: int = 0


OCEAN_CELLS = {
    # 2*320*328 = 209,920 triangles (divisible by 512), 32 layers
    "benchmark": OceanCell("benchmark", 320, 328, 512e3, 512e3, 32, 20,
                           60.0, 50.0),
    # 2*1280*1290 = 3,302,400 triangles, GBR-scale
    "gbr": OceanCell("gbr", 1280, 1290, 2000e3, 2600e3, 20, 20, 45.0,
                     120.0, reef=True),
    # communication-avoiding variant of the benchmark
    "benchmark-ca2": OceanCell("benchmark-ca2", 320, 328, 512e3, 512e3, 32,
                               20, 60.0, 50.0, halo_exchange_period=2),
}


def build_cell(cell: OceanCell, rank: int, n_parts: int,
               transport: Transport, device=None) -> DistributedOcean:
    """Rank `rank`'s DistributedOcean of `cell` on `n_parts` ranks, in
    float32 as the JAX package's cell (device None: the card)."""
    m = mesh2d.rect_mesh(cell.nx, cell.ny, cell.lx, cell.ly, jitter=0.2,
                         seed=7)
    if cell.reef:
        bf = mesh2d.reef_bathymetry(0.1 * cell.depth, cell.depth, cell.lx,
                                    cell.ly)
    else:
        bf = mesh2d.shelf_bathymetry(0.3 * cell.depth, cell.depth, cell.lx)
    # the nodes in float32, where the JAX package's cell evaluates b
    geom = geometry.geom2d_from_mesh(m, dtype=torch.float32, device="cpu")
    pts = np.stack([geom.node_x.numpy().ravel(),
                    geom.node_y.numpy().ravel()], axis=1)
    b = bf(pts).reshape(3, m.nt).astype(np.float32)
    cfg = stepper.OceanConfig(
        nl=cell.nl, dt=cell.dt, m_2d=cell.m_2d, coriolis_f=-4e-5,
        eos_kind="jackett", use_gls=True,
        halo_exchange_period=cell.halo_exchange_period)
    return DistributedOcean(m, b, cfg, rank, n_parts, transport,
                            dtype=torch.float32, device=device)
