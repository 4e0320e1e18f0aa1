"""Halo exchange over torch.distributed (paper §3.1-3.3).

One process per rank (the paper's one GPU per MPI rank).  Each exchange
offset of the partition (`distributed/partition.py`) becomes one ring
shift: every rank packs its send slots (`index_select` on the last axis),
sends the buffer to rank (r + off) % P, receives one from (r - off) % P —
the JAX package's `ppermute` with perm [(i, (i + off) % P)] — and unpacks
it into its halo slots (`index_copy`).  Every rank takes part in every
offset, with buffers padded to one size (padding lands in the trash slot).

Counters (the default metrics registry): ``halo.ppermute`` (ring shifts)
and ``halo.bytes`` (payload bytes sent).  The JAX package counts them once
at trace time, per compiled program; this eager port counts every shift it
executes, so one step's increase is the step's count and a run of n steps
counts n times as much.

The ``halo.payload`` chaos site fires on each received buffer before it is
unpacked, as in the JAX package (there at trace time; here on every
exchange until the fault's count is spent).

`shifts_per_step` and `bytes_per_step` are the closed forms of a step's
two counters on one rank.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import partition as part
from .. import tree as T
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..runtime import chaos as _chaos


@dataclasses.dataclass(frozen=True)
class HaloTables:
    """One rank's exchange tables: per ring offset, the local slots to pack
    (`send`) and the local slots (halo or trash) the arriving buffer fills
    (`recv`), each an int64 tensor of the offset's message size."""
    send: Tuple[torch.Tensor, ...]
    recv: Tuple[torch.Tensor, ...]
    offsets: Tuple[int, ...]
    n_parts: int


def tables_from_spec(spec: part.PartitionSpec2D, rank: int,
                     device=None) -> HaloTables:
    """Rank `rank`'s rows of the stacked (P, S) numpy tables, on `device`."""
    offs = tuple(sorted(spec.tables.keys()))
    idx = lambda a: torch.as_tensor(np.ascontiguousarray(a[rank]),
                                    dtype=torch.int64, device=device)
    return HaloTables(send=tuple(idx(spec.tables[o][0]) for o in offs),
                      recv=tuple(idx(spec.tables[o][1]) for o in offs),
                      offsets=offs, n_parts=spec.n_parts)


class Transport:
    """Ring shifts and all-gathers over the default torch.distributed
    process group.

    mode:
      ``nccl``         device tensors move over NCCL;
      ``gloo-staged``  gloo moves host tensors: a CUDA buffer is copied to
                       the host, moved, and copied back to its device, each
                       copy explicit (ranks that share one card: NCCL
                       refuses two ranks on one device); CPU buffers move
                       as they are;
      ``fake``         the group's backend is ``fake`` (the dry run,
                       `launch/mesh.py: init_fake_group`): one real rank
                       standing for all; a shift moves no data and returns
                       a copy of the buffer it was given, so that the halo
                       holds finite values;
      ``local``        no process group is initialised: one rank, whose
                       only shift is offset 0, a local copy.
    """

    def __init__(self):
        if dist.is_initialized():
            self.rank, self.size = dist.get_rank(), dist.get_world_size()
            backend = str(dist.get_backend()).lower()
            self.mode = {"nccl": "nccl", "fake": "fake"}.get(backend,
                                                             "gloo-staged")
        else:
            self.rank, self.size, self.mode = 0, 1, "local"

    def _wire_device(self, device: torch.device) -> torch.device:
        """Where a buffer of `device` moves: the host under gloo."""
        return torch.device("cpu") if self.mode == "gloo-staged" else device

    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self._wire_device(x.device)).contiguous()

    def shift(self, buf: torch.Tensor, off: int) -> torch.Tensor:
        """Send `buf` to rank (r + off) % P; return the buffer of the same
        shape that rank (r - off) % P sent."""
        if off % self.size == 0 or self.mode == "fake":
            return buf.clone()
        out = self._to_wire(buf)
        got = torch.empty_like(out)
        ops = [dist.P2POp(dist.isend, out, (self.rank + off) % self.size),
               dist.P2POp(dist.irecv, got, (self.rank - off) % self.size)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return got.to(buf.device)

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's `x` (all of one shape), in rank order, on the
        device of `x`."""
        if self.size == 1:
            return [x]
        wire = self._to_wire(x)
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire)
        return [p.to(x.device) for p in parts]

    def gather(self, x: torch.Tensor, dst: int = 0):
        """Every rank's `x` (all of one shape), in rank order, on the device
        of `x` on rank `dst`; None on the other ranks."""
        if self.size == 1:
            return [x]
        wire = self._to_wire(x)
        parts = ([torch.empty_like(wire) for _ in range(self.size)]
                 if self.rank == dst else None)
        dist.gather(wire, parts, dst=dst)
        return None if parts is None else [p.to(x.device) for p in parts]

    def scatter(self, parts, like: torch.Tensor, src: int = 0
                ) -> torch.Tensor:
        """Rank r's tensor of `parts` (given on rank `src` only, in rank
        order, each of the shape and dtype of `like`), on the device of
        `like`."""
        if self.size == 1:
            return parts[0].to(like.device)
        wire_dev = self._wire_device(like.device)
        got = torch.empty(like.shape, dtype=like.dtype, device=wire_dev)
        wires = (None if self.rank != src else
                 [p.to(wire_dev).contiguous() for p in parts])
        dist.scatter(got, wires, src=src)
        return got.to(like.device)

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


def _refresh_(x: torch.Tensor, t: HaloTables, transport: Transport
              ) -> torch.Tensor:
    """Refresh the halo slots of `x` (..., n_loc) in place; returns `x`."""
    reg = _metrics.default()
    with _trace.annotate("halo.exchange"):
        for off, sidx, ridx in zip(t.offsets, t.send, t.recv):
            buf = x.index_select(-1, sidx)
            reg.counter("halo.ppermute").inc()
            reg.counter("halo.bytes").inc(buf.numel() * buf.element_size())
            rbuf = transport.shift(buf, off)
            rbuf = _chaos.site("halo.payload", rbuf, offset=off)
            x.index_copy_(-1, ridx, rbuf)
    return x


def exchange(x: torch.Tensor, t: HaloTables, transport: Transport
             ) -> torch.Tensor:
    """Refresh the halo slots of one field (..., n_loc); returns a new
    tensor, `x` is not written."""
    return _refresh_(x.clone(), t, transport)


def exchange_tree(tree, t: HaloTables, transport: Transport):
    """Exchange every tensor leaf of a tree of (..., n_loc) fields."""
    return T.map_leaves(lambda x: exchange(x, t, transport), tree)


def exchange_batch(fields: Sequence[torch.Tensor], t: HaloTables,
                   transport: Transport) -> List[torch.Tensor]:
    """Exchange several same-shaped (..., n_loc) fields with ONE shift per
    ring offset (fields stacked on a new leading axis): the paper's message
    aggregation, which cuts the 2D mode's shift count by the field count."""
    return list(_refresh_(torch.stack(list(fields)), t, transport).unbind(0))


def shifts_per_step(n_offsets: int, period: int, m_2d: int) -> int:
    """Closed form of halo.ppermute a step: over both stages, 5 field
    exchanges and 3 m_sub (period 0) or m_sub / period (period > 0)
    batched 2D exchanges, each one shift per ring offset; m_sub is
    max(m_2d // 2, 1) in stage 1 and m_2d in stage 2."""
    total = 0
    for m_sub in (max(m_2d // 2, 1), m_2d):
        total += 5 + (3 * m_sub if period == 0 else m_sub // period)
    return total * n_offsets


def bytes_per_step(msg: Sequence[int], period: int, nl: int, itemsize: int,
                   m_2d: int) -> int:
    """Closed form of halo.bytes a step, for the message sizes ``msg`` (one
    a ring offset): ux, uy, T, S carry nl * 6 values a slot, eta 3, the
    stacked 2D state 3 x 3."""
    n2d = shifts_per_step(1, period, m_2d) - 10
    return sum(msg) * itemsize * (2 * (4 * nl * 6 + 3) + 9 * n2d)
