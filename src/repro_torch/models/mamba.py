"""Mamba (S6) block for the jamba hybrid architecture (the JAX package's
`models/mamba.py`), in plain torch: JAX computes it outside any Pallas
kernel.

Selective SSM with data-dependent (dt, B, C).  Prefill scans the tokens in
order; decode keeps (conv_state, ssm_state) per layer, O(1) per token.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..obs.trace import annotate
from .layers import (AllReduceSum, Draw, is_dtensor, tp_einsum,
                     traced_chunks)


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    def d_inner(self, d_model):
        return self.expand * d_model


def mamba_params(draw: Draw, d_model, cfg: MambaCfg, dtype=torch.bfloat16):
    di = cfg.d_inner(d_model)
    sc = 1.0 / (d_model ** 0.5)
    dt_rank = max(d_model // 16, 1)
    f32 = torch.float32
    a_log = torch.log(torch.arange(1, cfg.d_state + 1, dtype=f32))
    return {
        "w_in": draw.normal((d_model, 2 * di), sc, dtype),
        "conv_w": draw.normal((cfg.d_conv, di), 0.2, dtype),
        "conv_b": draw.full((di,), 0.0, dtype),
        "w_xdt": draw.normal((di, dt_rank), sc, dtype),
        "w_dt": draw.normal((dt_rank, di), 0.1, dtype),
        "dt_bias": draw.full((di,), -4.0, f32),      # softplus -> small dt
        "w_B": draw.normal((di, cfg.d_state), sc, dtype),
        "w_C": draw.normal((di, cfg.d_state), sc, dtype),
        "A_log": draw.const(a_log[None, :].repeat(di, 1)),   # (di, N)
        "D": draw.full((di,), 1.0, f32),
        "w_out": draw.normal((di, d_model), 1.0 / (di ** 0.5), dtype),
    }


def _scan_chunk(h, u, dt, B, C, A):
    """Steps of the recurrence from state h over u, dt (Bt, c, di) and B, C
    (Bt, c, N); returns (h after them, y (Bt, c, di))."""
    ys = []
    for t in range(u.shape[1]):
        dtt, ut = dt[:, t], u[:, t]
        dA = torch.exp(dtt[..., None] * A[None])          # (Bt, di, N)
        h = dA * h + (dtt * ut)[..., None] * B[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    return h, torch.stack(ys, dim=1)


def _ssm_scan(u, dt, B, C, A, D, chunk: int = 32):
    """u, dt: (Bt, T, di); B, C: (Bt, T, N); A: (di, N); D: (di,).

    h_t = exp(dt*A) h_{t-1} + dt*B_t*u_t ; y_t = (C_t . h_t) + D*u_t

    The per-token recurrence of JAX's default chunked scan, in chunks of
    `chunk` tokens (a ragged last one cut short: JAX needs T % chunk == 0).
    Under grad each chunk runs under `torch.utils.checkpoint`, as JAX's is
    `jax.checkpoint`'ed: the backward keeps one (Bt, di, N) state a chunk
    and recomputes inside it.  Each step's arithmetic is the same either
    way.  On fake tensors (`launch/lm_dryrun.py`) one chunk stands for all
    (`kernels/ops.py: counted`)."""
    Bt, T, di = u.shape
    h = u.new_zeros((Bt, di, A.shape[1]), dtype=torch.float32)
    n = T // chunk
    if ops.is_fake(u) and n > 1 and T % chunk == 0:
        # a dry run's trace (fake tensors): the per-token loop costs a
        # dispatch a token and layer, so the first chunk is traced and
        # counted for all n, forward and backward, and the output's other
        # chunks are copies that count nothing
        return traced_chunks(_scan_chunk, n, chunk, h, u, dt, B, C, A) \
            + D[None, None] * u
    ys = []
    for c0 in range(0, T, chunk):
        xs = [z[:, c0:c0 + chunk] for z in (u, dt, B, C)]
        if torch.is_grad_enabled():
            h, y = checkpoint(_scan_chunk, h, *xs, A, use_reentrant=False)
        else:
            h, y = _scan_chunk(h, *xs, A)
        ys.append(y)
    return torch.cat(ys, dim=1) + D[None, None] * u


def _dt_b_c(u, w_xdt, w_dt, dt_bias, w_B, w_C, reduce=None):
    """dt, B and C from the float32 activations u (..., di).  ``reduce``
    sums a product over di across the ranks that hold di's other channels
    (the identity when u holds every channel)."""
    reduce = reduce or (lambda t: t)
    dt = F.softplus(reduce(u @ w_xdt.float()) @ w_dt.float() + dt_bias)
    return dt, reduce(u @ w_B.float()), reduce(u @ w_C.float())


_SSM_KEYS = ("w_xdt", "w_dt", "dt_bias", "w_B", "w_C", "A_log", "D")
# the di dim of each weight of `_SSM_KEYS`
_SSM_DI = (0, 1, 0, 0, 0, 0, 0)


def _ssm_rows(u, w_xdt, w_dt, dt_bias, w_B, w_C, A_log, D, reduce=None):
    """The selective scan of float32 activations u (B, T, di)."""
    dt, Bm, Cm = _dt_b_c(u, w_xdt, w_dt, dt_bias, w_B, w_C, reduce)
    return _ssm_scan(u, dt, Bm, Cm, -torch.exp(A_log), D)


def _channels(u, weights) -> tuple:
    """The layout of mamba's SSM on DTensors, JAX's: each rank's batch rows
    (where u splits them) and its own di channels (where JAX's specs split
    `w_xdt`'s di), the other mesh dims replicated.  Returns (the mesh dims
    that split di, u's placements, the weights', the weights' gradients:
    partial sums over the mesh dims that split the rows)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    rows = [d for d, q in enumerate(u.placements) if q == Shard(0)]
    chan = [d for d, q in enumerate(weights[0].placements)
            if q == Shard(0) and d not in rows]
    u_pl = tuple(Shard(0) if d in rows else Shard(u.dim() - 1) if d in chan
                 else Replicate() for d in range(u.device_mesh.ndim))
    w_pl = tuple(tuple(Shard(di) if q == Shard(u.dim() - 1) else Replicate()
                       for q in u_pl) for di in _SSM_DI)
    grads = tuple(tuple(Partial() if q == Shard(0) else wq
                        for q, wq in zip(u_pl, pl)) for pl in w_pl)
    return chan, u_pl, w_pl, grads


def _ssm(u, *weights):
    """`_ssm_rows`; on a DTensor under `local_map` at `_channels`' layout:
    each rank scans its own rows and channels, the products over di to
    dt's rank, B and C all-reduced over the mesh dims that split di
    (`layers.AllReduceSum`); the rest is channel-local."""
    if not is_dtensor(u):
        return _ssm_rows(u, *weights)
    from torch.distributed.tensor.experimental import local_map
    chan, u_pl, w_pl, grads = _channels(u, weights)
    reduce = lambda t: AllReduceSum.apply(t, u.device_mesh, chan)
    with annotate("mamba._ssm"):
        return local_map(lambda *a: _ssm_rows(*a, reduce=reduce),
                         out_placements=(u_pl,), in_placements=(u_pl, *w_pl),
                         in_grad_placements=(u_pl, *grads),
                         redistribute_inputs=True)(u, *weights)


def mamba_apply(p, x, cfg: MambaCfg):
    """Train/prefill: x (B, T, D) -> (B, T, D)."""
    with annotate("mamba"):
        return _mamba_apply(p, x, cfg)


def _mamba_apply(p, x, cfg: MambaCfg):
    B, T, D = x.shape
    di = cfg.d_inner(D)
    xi, z = tp_einsum("btd,de->bte", x, p["w_in"]).chunk(2, dim=-1)  # (B, T, di)
    # causal depthwise conv, summed in JAX's order
    xpad = torch.cat([xi.new_zeros((B, cfg.d_conv - 1, di)), xi], dim=1)
    conv = sum(xpad[:, k:k + T, :] * p["conv_w"][k][None, None]
               for k in range(cfg.d_conv)) + p["conv_b"]
    u = F.silu(conv).float()
    y = _ssm(u, *(p[k] for k in _SSM_KEYS))
    return tp_einsum("bte,ed->btd", y.to(x.dtype) * F.silu(z), p["w_out"])


def _ssm_step_rows(u, h, w_xdt, w_dt, dt_bias, w_B, w_C, A_log, D,
                   reduce=None):
    """One decode step of the selective SSM: float32 u (B, di), state h
    (B, di, N) -> (y (B, di), the new state)."""
    dt, Bm, Cm = _dt_b_c(u, w_xdt, w_dt, dt_bias, w_B, w_C, reduce)
    A = -torch.exp(A_log)
    dA = torch.exp(dt[..., None] * A[None])               # (B, di, N)
    h = dA * h + (dt * u)[..., None] * Bm[:, None, :]
    return torch.einsum("bdn,bn->bd", h, Cm) + D[None] * u, h


def _ssm_step(u, h, *weights):
    """`_ssm_step_rows`; on DTensors under `local_map` as `_ssm`, each rank
    stepping its own rows and channels, the state (B, di, N) split over di
    as JAX's cache spec splits it."""
    if not is_dtensor(u):
        return _ssm_step_rows(u, h, *weights)
    from torch.distributed.tensor.experimental import local_map
    chan, u_pl, w_pl, _ = _channels(u, weights)
    reduce = lambda t: AllReduceSum.apply(t, u.device_mesh, chan)
    with annotate("mamba._ssm"):
        return local_map(lambda *a: _ssm_step_rows(*a, reduce=reduce),
                         out_placements=(u_pl, u_pl),
                         in_placements=(u_pl, u_pl, *w_pl),
                         redistribute_inputs=True)(u, h, *weights)


def mamba_decode(p, x, state, cfg: MambaCfg):
    """Single-token decode. x (B, 1, D); state = (conv_state (B, d_conv-1, di),
    ssm_state (B, di, N)). Returns (out, new_state)."""
    with annotate("mamba"):
        xi, z = tp_einsum("bd,de->be", x[:, 0], p["w_in"]).chunk(2, dim=-1)
        conv_state, h = state
        xc = torch.cat([conv_state, xi[:, None]], dim=1)     # (B, d_conv, di)
        conv = (xc * p["conv_w"][None]).sum(dim=1) + p["conv_b"]
        u = F.silu(conv).float()                              # (B, di)
        y, h = _ssm_step(u, h, *(p[k] for k in _SSM_KEYS))
        out = tp_einsum("be,ed->bd", y.to(x.dtype) * F.silu(z), p["w_out"])
        return out[:, None], (xc[:, 1:], h)


def init_mamba_state(batch, d_model, cfg: MambaCfg, dtype=torch.bfloat16,
                     device="cpu"):
    di = cfg.d_inner(d_model)
    return (torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype, device=device),
            torch.zeros((batch, di, cfg.d_state), dtype=torch.float32,
                        device=device))
