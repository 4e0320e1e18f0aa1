"""Horizontal domain decomposition (paper §3): a numpy copy of the JAX
package's `distributed/partition.py`, kept in this package so the port runs
without JAX, built on the port's `core.mesh2d`.

The Hilbert-ordered triangle list is cut into P contiguous equal stripes
(one per device — the paper's one-GPU-per-MPI-rank).  Each partition stores a
k-deep layer of ghost triangles from neighbouring partitions; neighbour
accesses on owned triangles hit the ghost layer, which is refreshed by halo
exchanges (distributed/halo.py).

Design points (DESIGN.md §2):
  * ghost-compute: every partition redundantly computes on its ghost ring(s);
    a state exchange at (sub)stage boundaries revalidates them.  A k-deep
    halo allows k flux stages between exchanges (communication-avoiding,
    beyond-paper opt #2) at the cost of (k-1) rings of redundant compute.
  * static shapes: all partitions are padded to the same owned size, halo
    size, and per-offset message size, so one SPMD program serves all ranks
    (ppermute needs uniform buffers).  A trailing "trash" slot absorbs
    scatter targets of padded message entries.
  * exchange topology: with Hilbert stripes the neighbour set is a small set
    of ring offsets (usually +-1, occasionally +-2..4 where the curve
    revisits); each offset becomes one ring shift (distributed/halo.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..core import mesh2d


@dataclasses.dataclass(frozen=True)
class PartitionSpec2D:
    """Numpy build-time partition description (stacked over partitions)."""
    n_parts: int
    n_own: int                    # owned triangles per partition (uniform)
    n_loc: int                    # own + halo + 1 trash slot
    # local connectivity, stacked (P, 3, n_loc):
    neigh_tri: np.ndarray
    neigh_edge: np.ndarray
    edge_type: np.ndarray
    # global triangle id per local slot (P, n_loc); trash slot repeats slot 0
    glob_ids: np.ndarray
    # per-offset exchange tables: offset -> (send_idx, recv_idx) each (P, S)
    # send entries index local slots to pack; recv entries are local slots
    # (halo or trash) where the arriving buffer lands.
    tables: Dict[int, Tuple[np.ndarray, np.ndarray]]
    owned_mask: np.ndarray        # (P, n_loc) 1.0 for owned slots


def build_partition(mesh: mesh2d.Mesh2D, n_parts: int,
                    halo_depth: int = 1) -> PartitionSpec2D:
    nt = mesh.nt
    assert nt % n_parts == 0, (nt, n_parts)
    n_own = nt // n_parts
    owner = np.arange(nt) // n_own                       # contiguous stripes

    # --- halo sets (k rings of neighbour triangles) --------------------------
    halos: List[np.ndarray] = []
    for p in range(n_parts):
        frontier = np.arange(p * n_own, (p + 1) * n_own)
        seen = set(frontier.tolist())
        halo: List[int] = []
        for _ in range(halo_depth):
            nxt = np.unique(mesh.neigh_tri[frontier].ravel())
            new = [t for t in nxt.tolist() if t not in seen]
            halo.extend(new)
            seen.update(new)
            frontier = np.array(new, dtype=np.int64) if new else np.array([], np.int64)
        halos.append(np.array(sorted(halo), dtype=np.int64))

    n_halo = max(len(h) for h in halos)
    n_loc = n_own + n_halo + 1                           # +1 trash slot
    trash = n_loc - 1

    glob_ids = np.zeros((n_parts, n_loc), np.int64)
    g2l = np.full((n_parts, nt), -1, np.int64)
    for p in range(n_parts):
        own = np.arange(p * n_own, (p + 1) * n_own)
        h = halos[p]
        pad = np.full(n_halo - len(h), own[0], np.int64)  # pad w/ own slot 0
        ids = np.concatenate([own, h, pad, own[:1]])
        glob_ids[p] = ids
        g2l[p, own] = np.arange(n_own)
        g2l[p, h] = n_own + np.arange(len(h))

    # --- local connectivity ---------------------------------------------------
    neigh_tri = np.zeros((n_parts, 3, n_loc), np.int64)
    neigh_edge = np.zeros((n_parts, 3, n_loc), np.int64)
    edge_type = np.zeros((n_parts, 3, n_loc), np.int64)
    for p in range(n_parts):
        gids = glob_ids[p]
        gn = mesh.neigh_tri[gids]                         # (n_loc, 3) global
        ln = g2l[p, gn]                                   # local or -1
        # unknown neighbours (outside own+halo) -> self (ghost-compute garbage
        # ring; never read by valid cells)
        self_idx = np.arange(n_loc)[:, None]
        ln = np.where(ln < 0, self_idx, ln)
        et = mesh.edge_type[gids]
        ne = mesh.neigh_edge[gids]
        neigh_tri[p] = ln.T
        neigh_edge[p] = ne.T
        edge_type[p] = et.T

    # --- exchange tables --------------------------------------------------------
    # partition q needs triangle t (owned by o(t)) in its halo -> o(t) sends.
    traffic: Dict[int, List[List[Tuple[int, int]]]] = {}
    for q in range(n_parts):
        for t in halos[q]:
            src = int(owner[t])
            off = (q - src) % n_parts
            traffic.setdefault(off, [[] for _ in range(n_parts)])
            # sender src packs local slot of t; receiver q scatters to its
            # local halo slot of t
            traffic[off][src].append((int(g2l[src, t]), int(g2l[q, t])))

    tables: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for off, per_src in traffic.items():
        S = max(len(v) for v in per_src)
        send = np.zeros((n_parts, S), np.int64)
        recv = np.full((n_parts, S), trash, np.int64)
        for src in range(n_parts):
            pairs = per_src[src]
            dst = (src + off) % n_parts
            for j, (sl, rl) in enumerate(pairs):
                send[src, j] = sl
                recv[dst, j] = rl
            # padded send entries pack slot 0 (garbage) -> receiver scatters
            # them to its trash slot (recv already defaults to trash)
        tables[off] = (send, recv)

    owned_mask = np.zeros((n_parts, n_loc))
    owned_mask[:, :n_own] = 1.0

    return PartitionSpec2D(
        n_parts=n_parts, n_own=n_own, n_loc=n_loc,
        neigh_tri=neigh_tri, neigh_edge=neigh_edge, edge_type=edge_type,
        glob_ids=glob_ids, tables=tables, owned_mask=owned_mask)


def local_mesh(mesh: mesh2d.Mesh2D, spec: PartitionSpec2D,
               rank: int) -> mesh2d.Mesh2D:
    """The Mesh2D of one partition over its local triangle slots (for
    building its local Geom2D); vertex coordinates are shared.  A rank
    builds only its own."""
    return mesh2d.Mesh2D(
        xy=mesh.xy,
        tri=mesh.tri[spec.glob_ids[rank]],
        neigh_tri=spec.neigh_tri[rank].T,
        neigh_edge=spec.neigh_edge[rank].T,
        edge_type=spec.edge_type[rank].T,
    )


def local_meshes(mesh: mesh2d.Mesh2D, spec: PartitionSpec2D):
    """Per-partition Mesh2D objects over the local triangle slots."""
    return [local_mesh(mesh, spec, p) for p in range(spec.n_parts)]


def scatter_field(spec: PartitionSpec2D, f_global: np.ndarray) -> np.ndarray:
    """Global (..., nt) nodal field -> stacked local (P, ..., n_loc)."""
    return np.stack([f_global[..., spec.glob_ids[p]]
                     for p in range(spec.n_parts)])


def gather_field(spec: PartitionSpec2D, f_local: np.ndarray) -> np.ndarray:
    """Stacked local (P, ..., n_loc) -> global (..., nt) (owned slots only)."""
    P, n_own = spec.n_parts, spec.n_own
    parts = [f_local[p][..., :n_own] for p in range(P)]
    return np.concatenate(parts, axis=-1)
