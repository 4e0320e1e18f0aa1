"""Mixture-of-Experts layers (the JAX package's `models/moe.py`), in plain
torch: top-k routing, dense (einsum) dispatch, shared experts (qwen2-moe)
and the Switch load-balancing auxiliary loss.

Dense dispatch computes every expert for every token and combines them
with weights that are zero outside the top k, as JAX does.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..obs.trace import annotate
from .layers import Draw, is_dtensor, mlp, pin


@dataclasses.dataclass(frozen=True)
class MoeCfg:
    n_experts: int
    top_k: int
    d_ff: int                   # per-expert hidden size
    n_shared: int = 0           # always-on shared experts (qwen2)
    router_aux_coef: float = 0.01


def moe_params(draw: Draw, d_model, cfg: MoeCfg, act: str, dtype=torch.bfloat16):
    E, Fd = cfg.n_experts, cfg.d_ff
    sc_in = 1.0 / (d_model ** 0.5)
    sc_out = 1.0 / (Fd ** 0.5)
    p = {
        "router": draw.normal((d_model, E), sc_in, torch.float32),
        "w_gate": draw.normal((E, d_model, Fd), sc_in, dtype),
        "w_in": draw.normal((E, d_model, Fd), sc_in, dtype),
        "w_out": draw.normal((E, Fd, d_model), sc_out, dtype),
    }
    if cfg.n_shared > 0:
        Fs = Fd * cfg.n_shared
        p["shared"] = {
            "w_gate": draw.normal((d_model, Fs), sc_in, dtype),
            "w_in": draw.normal((d_model, Fs), sc_in, dtype),
            "w_out": draw.normal((Fs, d_model), sc_out, dtype),
        }
    return p


def top_k(x, k: int):
    """`jax.lax.top_k`: the k largest along the last axis, ties to the lower
    index (a stable descending sort; `torch.topk` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_rows(probs, k: int, n_experts: int):
    """(combine weights (B, T, E): zero except the top k, renormalised;
    picks (B, T, E): 1 for each of the top k)."""
    topv, topi = top_k(probs, k)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    onehot = F.one_hot(topi, n_experts).to(probs.dtype)
    return torch.einsum("btk,btke->bte", topv, onehot), onehot.sum(dim=2)


def _route(probs, k: int, n_experts: int):
    """`_route_rows`; on a DTensor under `local_map`, each rank routing its
    own tokens with every expert's probability (DTensor has no rule for
    the stable sort of `top_k` nor for `one_hot`)."""
    if not is_dtensor(probs):
        return _route_rows(probs, k, n_experts)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    last = probs.dim() - 1
    pl = tuple(Replicate() if q == Shard(last) else q for q in probs.placements)
    return local_map(lambda pr: _route_rows(pr, k, n_experts),
                     out_placements=(pl, pl), in_placements=(pl,),
                     redistribute_inputs=True)(probs)


def _expert_in(x, w):
    """"btd,edf->btef": x (B, T, D) through every expert's (D, F) weight.
    On DTensors under `local_map` (DTensor's einsum flattens (e, f), which
    fails when f is split or e unevenly): each rank's rows of x, D whole,
    against its slice of the experts (E) or of their hidden dim (F); no
    communication.  The gradients: x's a partial sum over the mesh dims
    that split w, w's over those that split x's rows."""
    if not is_dtensor(x):
        return torch.einsum("btd,edf->btef", x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    w_pl = tuple(q if q in (Shard(0), Shard(2)) else Replicate()
                 for q in w.placements)
    x_pl = tuple(q if q in (Shard(0), Shard(1)) and wq == Replicate()
                 else Replicate() for q, wq in zip(x.placements, w_pl))
    out = tuple(Shard(2) if wq == Shard(0) else Shard(3) if wq == Shard(2)
                else xq for xq, wq in zip(x_pl, w_pl))
    x_grad = tuple(Partial() if wq != Replicate() else xq
                   for xq, wq in zip(x_pl, w_pl))
    w_grad = tuple(Partial() if xq != Replicate() else wq
                   for xq, wq in zip(x_pl, w_pl))
    return local_map(lambda x_, w_: torch.einsum("btd,edf->btef", x_, w_),
                     out_placements=(out,), in_placements=(x_pl, w_pl),
                     in_grad_placements=(x_grad, w_grad),
                     redistribute_inputs=True)(x, w)


def _expert_out(h, w_out, comb):
    """"btef,efd,bte->btd": the experts' outputs (E, F, D) weighted by
    comb (B, T, E) and summed.  On DTensors under `local_map` at h's
    placements: w_out and comb cut to each rank's experts and hidden
    units, the sum a partial one over the mesh dims that split them (and
    w_out's gradient over those that split the rows, comb's over those
    that split F)."""
    eq = "btef,efd,bte->btd"
    if not is_dtensor(h):
        return torch.einsum(eq, h, w_out, comb)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    h_pl = tuple(h.placements)
    w_pl = tuple(Shard(0) if q == Shard(2) else Shard(1) if q == Shard(3)
                 else Replicate() for q in h_pl)
    c_pl = tuple(q if q in (Shard(0), Shard(1), Shard(2)) else Replicate()
                 for q in h_pl)
    out = tuple(q if q in (Shard(0), Shard(1)) else
                Partial() if q in (Shard(2), Shard(3)) else Replicate()
                for q in h_pl)
    rows = (Shard(0), Shard(1))
    w_grad = tuple(Partial() if q in rows else wq for q, wq in zip(h_pl, w_pl))
    c_grad = tuple(Partial() if q == Shard(3) else cq
                   for q, cq in zip(h_pl, c_pl))
    return local_map(lambda h_, w_, c_: torch.einsum(eq, h_, w_, c_),
                     out_placements=(out,), in_placements=(h_pl, w_pl, c_pl),
                     in_grad_placements=(h_pl, w_grad, c_grad),
                     redistribute_inputs=True)(h, w_out, comb)


def moe_apply(p, x, cfg: MoeCfg, hidden_sharding=None):
    """x (B, T, D) -> (out, aux_loss).

    hidden_sharding: optional (DeviceMesh, placements) for the (B, T, E,
    F) dispatch intermediates, applied to DTensors (JAX pins them for
    single-token decode, keeping the expert weights 2D-sharded)."""
    with annotate("moe_apply"):
        return _moe_apply(p, x, cfg, hidden_sharding)


def _moe_apply(p, x, cfg: MoeCfg, hidden_sharding):
    logits = x.float() @ p["router"]                      # (B, T, E)
    probs = torch.softmax(logits, dim=-1)
    comb, picked = _route(probs, cfg.top_k, cfg.n_experts)

    # dense dispatch: every expert sees every token, weighted combine
    h_gate = _expert_in(x, p["w_gate"])
    h_in = _expert_in(x, p["w_in"])
    h_gate, h_in = pin(h_gate, hidden_sharding), pin(h_in, hidden_sharding)
    h = F.silu(h_gate) * h_in
    out = _expert_out(h, p["w_out"], comb.to(h.dtype))

    if cfg.n_shared > 0:
        out = out + mlp(p["shared"], x, "swiglu")

    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    frac = picked.mean(dim=(0, 1))                        # (E,) token fraction
    pmean = probs.mean(dim=(0, 1))
    aux = cfg.n_experts * torch.sum(frac * pmean) * cfg.router_aux_coef
    return out.to(x.dtype), aux
