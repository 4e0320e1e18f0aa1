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

from .layers import Draw, is_dtensor, pin


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


def moe_apply(p, x, cfg: MoeCfg, hidden_sharding=None):
    """x (B, T, D) -> (out, aux_loss).

    hidden_sharding: optional (DeviceMesh, placements) for the (B, T, E,
    F) dispatch intermediates, applied to DTensors (JAX pins them for
    single-token decode, keeping the expert weights 2D-sharded)."""
    logits = x.float() @ p["router"]                      # (B, T, E)
    probs = torch.softmax(logits, dim=-1)
    comb, picked = _route(probs, cfg.top_k, cfg.n_experts)

    # dense dispatch: every expert sees every token, weighted combine
    h_gate = torch.einsum("btd,edf->btef", x, p["w_gate"])
    h_in = torch.einsum("btd,edf->btef", x, p["w_in"])
    h_gate, h_in = pin(h_gate, hidden_sharding), pin(h_in, hidden_sharding)
    h = F.silu(h_gate) * h_in
    out = torch.einsum("btef,efd,bte->btd", h, p["w_out"], comb.to(h.dtype))

    if cfg.n_shared > 0:
        s = p["shared"]
        hs = F.silu(x @ s["w_gate"]) * (x @ s["w_in"])
        out = out + hs @ s["w_out"]

    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    frac = picked.mean(dim=(0, 1))                        # (E,) token fraction
    pmean = probs.mean(dim=(0, 1))
    aux = cfg.n_experts * torch.sum(frac * pmean) * cfg.router_aux_coef
    return out.to(x.dtype), aux
