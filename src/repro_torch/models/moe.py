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

from .layers import Draw


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


def moe_apply(p, x, cfg: MoeCfg):
    """x (B, T, D) -> (out, aux_loss)."""
    logits = x.float() @ p["router"]                      # (B, T, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k(probs, cfg.top_k)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    # combine weights (B, T, E): zero except top-k entries
    onehot = F.one_hot(topi, cfg.n_experts).to(probs.dtype)
    comb = torch.einsum("btk,btke->bte", topv, onehot)

    # dense dispatch: every expert sees every token, weighted combine
    h_gate = torch.einsum("btd,edf->btef", x, p["w_gate"])
    h_in = torch.einsum("btd,edf->btef", x, p["w_in"])
    h = F.silu(h_gate) * h_in
    out = torch.einsum("btef,efd,bte->btd", h, p["w_out"], comb.to(h.dtype))

    if cfg.n_shared > 0:
        s = p["shared"]
        hs = F.silu(x @ s["w_gate"]) * (x @ s["w_in"])
        out = out + hs @ s["w_out"]

    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    frac = onehot.sum(dim=2).mean(dim=(0, 1))             # (E,) token fraction
    pmean = probs.mean(dim=(0, 1))
    aux = cfg.n_experts * torch.sum(frac * pmean) * cfg.router_aux_coef
    return out.to(x.dtype), aux
