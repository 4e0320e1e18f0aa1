"""Distributed ocean runtime: the split-IMEX step on one rank of a
partitioned mesh.

One process per rank (the paper's one GPU per MPI rank), triangles cut into
Hilbert stripes (`partition.py`), ghost rings refreshed by ring shifts over
torch.distributed (`halo.py`).  Each rank builds only its own local mesh,
geometry and tables.  `gather_state` all-gathers the owned slots so that
every rank holds the global state (the JAX package's `device_get` view).
A checkpoint holds that global state, gathered onto rank 0 alone and
written there; a restore is read on rank 0 and scattered, each rank
receiving only its own slots.  So a run on P ranks restores onto any other
rank count, or onto one device.

Each rank's local step dispatches its kernels as the single-device step
does: ``auto`` runs the CUDA kernels on the card and their plain versions
on the CPU.  (The JAX package pins its distributed step to ``ref``, with a
warning: there the local step is one `shard_map` program over every
partition.  Here a rank is an ordinary process whose local step is the
single-device step on n_loc triangles, so nothing needs the pin.)

    transport = halo.Transport()          # after init_process_group
    do = DistributedOcean(mesh, b, cfg, transport.rank, transport.size,
                          transport, device="cpu")
    st = do.scatter_state(global_state)
    step = do.make_step()
    st = step(st)
    out = do.gather_state(st)
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import halo, partition
from .. import tree as T
from ..core import geometry, mesh2d, stepper
from ..core.dg2d import State2D
from ..core.extrusion import VGrid
from ..kernels.dispatch import default_device
from ..obs import metrics as _metrics
from ..obs import trace as _trace


class DistributedOcean:
    """Rank `rank`'s partition data and its local step."""

    def __init__(self, mesh: mesh2d.Mesh2D, b_nodal: np.ndarray,
                 cfg: stepper.OceanConfig, rank: int, n_parts: int,
                 transport: halo.Transport, halo_depth: Optional[int] = None,
                 dtype=torch.float64, device=None):
        self.cfg = cfg
        self.rank, self.n_parts, self.transport = rank, n_parts, transport
        self.device = default_device(device)
        self.dtype = dtype
        if halo_depth is None:
            halo_depth = max(1, 3 * cfg.halo_exchange_period)
        self.spec = partition.build_partition(mesh, n_parts, halo_depth)
        self.geom = geometry.geom2d_from_mesh(
            partition.local_mesh(mesh, self.spec, rank), dtype=dtype,
            device=self.device)
        self.b = self._local(np.asarray(b_nodal))
        self.vg = VGrid(b=self.b, nl=self.cfg.nl)
        self.tables = halo.tables_from_spec(self.spec, rank, self.device)

        reg = _metrics.default()
        reg.gauge("distributed.n_parts").set(n_parts)
        reg.gauge("distributed.halo_depth").set(halo_depth)
        reg.gauge("distributed.nt_local").set(self.spec.n_loc)
        reg.gauge("distributed.halo_slots").set(
            sum(int(s.shape[-1]) for s in self.tables.send))

    def _local(self, x) -> torch.Tensor:
        """This rank's slots of a global (..., nt) field, on its device."""
        x = torch.as_tensor(np.asarray(x))
        ids = torch.as_tensor(self.spec.glob_ids[self.rank])
        return x[..., ids].to(device=self.device, dtype=self.dtype)

    # -- state scatter/gather ----------------------------------------------
    def scatter_state(self, st: stepper.OceanState) -> stepper.OceanState:
        """This rank's local state from a global one (on any device)."""
        def sc(x):
            x = x.detach().cpu() if isinstance(x, torch.Tensor) else x
            if np.ndim(x) == 0:
                return torch.as_tensor(x, dtype=self.dtype, device=self.device)
            return self._local(x)
        return T.map_leaves(sc, st)

    def gather_state(self, st: stepper.OceanState,
                     dst: Optional[int] = None
                     ) -> Optional[stepper.OceanState]:
        """The global state from every rank's owned slots, on this rank's
        device (a collective: every rank calls it).  With `dst`, only rank
        `dst` receives it and the others return None."""
        n_own = self.spec.n_own

        def ga(x):
            if x.ndim == 0:       # time
                return x
            own = x[..., :n_own].contiguous()
            parts = (self.transport.all_gather(own) if dst is None
                     else self.transport.gather(own, dst))
            return None if parts is None else torch.cat(parts, dim=-1)
        out = T.map_leaves(ga, st)
        return out if dst is None or self.rank == dst else None

    def init_state(self) -> stepper.OceanState:
        """The local initial state (fluid at rest, uniform T and S)."""
        return stepper.init_state(self.geom, self.vg, dtype=self.dtype)

    # -- checkpoints -------------------------------------------------------
    def save(self, ckpt, step: int, st: stepper.OceanState) -> None:
        """Gather the global state onto rank 0 and write it there (a
        collective); every rank returns once the checkpoint is on disk."""
        glob = self.gather_state(st, dst=0)
        if self.rank == 0:
            ckpt.save(step, glob, blocking=True)
        self.transport.barrier()

    def restore(self, ckpt, step: Optional[int] = None) -> stepper.OceanState:
        """Restore a global checkpoint, written from any rank count or from
        one device: rank 0 reads and verifies it, and sends every rank its
        own slots (a collective)."""
        template = self.init_state()
        glob = (T.leaves(ckpt.restore(template, step=step, devices="cpu"))
                if self.rank == 0 else None)
        ids = [torch.as_tensor(g) for g in self.spec.glob_ids]

        def parts(i, like):
            if glob is None:
                return None
            x = glob[i]
            return ([x] * self.n_parts if like.ndim == 0       # time
                    else [x[..., g] for g in ids])
        return T.unflatten(template, [
            self.transport.scatter(parts(i, like), like)
            for i, like in enumerate(T.leaves(template))])

    # -- the local step ----------------------------------------------------
    def make_step(self, forcing: Optional[stepper.Forcing3D] = None):
        """The local step with the halo hooks: the evaluation fields are
        exchanged at each stage, the 2D state inside the external burst.

        `forcing` goes into the local step as given, as in the JAX package:
        a forcing field of the global (..., nt) shape does not fit the
        local (..., n_loc) one and fails there."""
        cfg, tables, tr = self.cfg, self.tables, self.transport
        forcing = forcing if forcing is not None else stepper.Forcing3D()

        def ex2d(s2):
            eta, qx, qy = halo.exchange_batch([s2.eta, s2.qx, s2.qy],
                                              tables, tr)
            return State2D(eta, qx, qy)

        def exf(f):
            return halo.exchange(f, tables, tr)

        def step_fn(st: stepper.OceanState) -> stepper.OceanState:
            with _trace.annotate("distributed.local_step"):
                return stepper.step(self.geom, self.vg, cfg, st, forcing,
                                    exchange2d=ex2d, exchange_field=exf)
        return step_fn
