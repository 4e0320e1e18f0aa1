"""AdamW with global-norm clipping (the JAX package's `optim/adamw.py`).

Plain functions on trees of tensors (`repro_torch.tree`: the parameter
dicts of `models/`), in JAX's order of operations, not `torch.optim`'s:
the global norm of the float32 gradients, one clipping scale, then per
leaf m and v in float32, the bias corrections, and the step and weight
decay applied to a float32 copy of the parameter, rounded back to the
parameter's dtype.  Master weights stay in the parameter dtype; moments
in float32.

`update` returns new trees and leaves its inputs as they are, as JAX's
does.  ``inplace=True`` writes the same numbers into the given parameter
and moment tensors instead, a slice of the leading axis at a time, so the
step holds one copy of the model state and no leaf-sized temporaries (a
second copy of rwkv6-3b's bfloat16 parameters and float32 moments, ~29 GB,
does not fit beside the first on an 80 GB card).  The caller's trees then
change: a runner that keeps its start state to restore from must not run
such a step with retries.

On a mesh the leaves are DTensors: `init` makes each moment on its
parameter's placements, `global_norm` is the norm over every shard (each
leaf's sum of squares reduced over the mesh), and `update` first
redistributes each gradient to its parameter's placements (autograd may
return one replicated or as a partial sum) and then updates each rank's
local shards, which line up element for element; ``inplace`` writes into
`to_local()`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from .. import tree
from ..launch.mesh import is_dtensor


class AdamWState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor          # int32 scalar


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init(params) -> AdamWState:
    """Zero moments in float32 beside each leaf (on its placements on a
    mesh), and step 0."""
    def zeros(p):
        if is_dtensor(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree.leaves(params)[0].device
    return AdamWState(m=tree.map_leaves(zeros, params),
                      v=tree.map_leaves(zeros, params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in leaf order) of sum(g^2), float32; a
    DTensor leaf's sum over all its shards (a plain tensor)."""
    total = None
    for g in tree.leaves(grads):
        sq = torch.sum(torch.square(g.float()))
        if is_dtensor(sq):
            sq = sq.full_tensor()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


SLICE_ELEMS = 1 << 24     # elements of one slice of an in-place update


def update(grads, state: AdamWState, params, cfg: AdamWConfig = AdamWConfig(),
           inplace: bool = False):
    """Returns (new_params, new_state); with ``inplace`` they are ``params``
    and ``state``'s moments, updated."""
    f32 = torch.float32
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-12), max=1.0)
    step = state.step + 1
    stepf = step.to(f32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=f32, device=stepf.device),
                          stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=f32, device=stepf.device),
                          stepf)

    def upd(g, m, v, p):
        g = g.to(f32) * scale
        m1 = cfg.b1 * m + (1 - cfg.b1) * g
        v1 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mh = m1 / bc1
        vh = v1 / bc2
        pf = p.to(f32)
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
        return (pf - cfg.lr * delta).to(p.dtype), m1, v1

    leaves = zip(tree.leaves(grads), tree.leaves(state.m),
                 tree.leaves(state.v), tree.leaves(params))
    if is_dtensor(tree.leaves(params)[0]):
        return _update_sharded(leaves, upd, params, state, step, inplace)
    if inplace:
        for g, m, v, p in leaves:
            _update_inplace(upd, g, m, v, p)
        return params, AdamWState(m=state.m, v=state.v, step=step)
    out = [upd(*a) for a in leaves]
    new = [tree.unflatten(params, [o[i] for o in out]) for i in range(3)]
    return new[0], AdamWState(m=new[1], v=new[2], step=step)


def _update_inplace(upd, g, m, v, p) -> None:
    """``upd`` written into m, v and p, a slice of the leading axis at a
    time."""
    rows = max(1, SLICE_ELEMS // max(1, p[0].numel())) if p.dim() else 1
    parts = ([(g, m, v, p)] if p.dim() == 0 else
             zip(*(t.split(rows) for t in (g, m, v, p))))
    for gs, ms, vs, ps in parts:
        p1, m1, v1 = upd(gs, ms, vs, ps)
        ps.copy_(p1)
        ms.copy_(m1)
        vs.copy_(v1)


def _update_sharded(leaves, upd, params, state: AdamWState, step, inplace):
    """`update` on DTensor leaves: each gradient, and the parameter where
    the moments are split further (ZeRO-1, `sharding.opt_pspecs`),
    redistributed to the moments' placements, then ``upd`` on the local
    shards; such a parameter's new value is gathered back to its own
    placements."""
    from torch.distributed.tensor import DTensor
    outs = []
    for g, m, v, p in leaves:
        mesh, pl = m.device_mesh, tuple(m.placements)
        g = g.redistribute(mesh, pl)
        pm = p if tuple(p.placements) == pl else p.redistribute(mesh, pl)
        local = [t.to_local() for t in (g, m, v, pm)]
        if inplace:
            _update_inplace(upd, *local)
            if pm is not p:
                p.to_local().copy_(pm.redistribute(mesh, p.placements)
                                   .to_local())
            continue
        p1, m1, v1 = upd(*local)
        outs.append([DTensor.from_local(t, mesh, pl, shape=p.shape,
                                        stride=p.stride())
                     for t in (p1, m1, v1)])
        outs[-1][0] = outs[-1][0].redistribute(mesh, p.placements)
    if inplace:
        return params, AdamWState(m=state.m, v=state.v, step=step)
    new = [tree.unflatten(params, [o[i] for o in outs]) for i in range(3)]
    return new[0], AdamWState(m=new[1], v=new[2], step=step)
