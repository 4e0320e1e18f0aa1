"""RWKV6 (Finch) block (the JAX package's `models/rwkv.py`): time-mix with
data-dependent decay, and channel-mix.

Prefill (no carried state) runs the WKV recurrence through `ops.wkv6` (K8
on the card), which starts from S = 0 and returns no final state, the
prefill contract (JAX discards S_T there).  Decode carries (token shift,
WKV state) and steps `_wkv_with_state` in plain torch on every backend, as
JAX does outside any Pallas kernel.

Training: with inputs that require grad, `ops.wkv6` on ``plain`` and
``cuda`` goes through `WKV6`, whose forward is the op (K8 on the card)
and whose backward recomputes `wkv_chunked`, the port of JAX's chunked
form (the function JAX's forward runs and differentiates), from the
saved r, k, v, w and u, and returns its gradient: the gradient JAX takes.
Each chunk's body runs under `torch.utils.checkpoint`, as JAX's is
`jax.checkpoint`'ed, so the backward keeps one state a chunk.

The dtype chain is JAX's: the projections in the activations' dtype, the
decay w = exp(-exp(decay + dd)) in float32, w rounded to the activations'
dtype on prefill, the recurrence in float32, `out * (1 + ln_x)` in float32
and the cast before `w_o`.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..obs.trace import annotate
from .layers import (Draw, core_placements, is_dtensor, pin, tp_einsum,
                     traced_chunks)


@dataclasses.dataclass(frozen=True)
class RwkvCfg:
    head_dim: int = 64

    def n_heads(self, d_model):
        return d_model // self.head_dim


def rwkv_params(draw: Draw, d_model, d_ff, cfg: RwkvCfg, dtype=torch.bfloat16):
    sc = 1.0 / (d_model ** 0.5)
    lora = max(d_model // 16, 32)
    f32 = torch.float32
    return {
        "mix_r": draw.full((d_model,), 0.5, dtype),
        "mix_k": draw.full((d_model,), 0.5, dtype),
        "mix_v": draw.full((d_model,), 0.5, dtype),
        "mix_w": draw.full((d_model,), 0.5, dtype),
        "w_r": draw.normal((d_model, d_model), sc, dtype),
        "w_k": draw.normal((d_model, d_model), sc, dtype),
        "w_v": draw.normal((d_model, d_model), sc, dtype),
        "w_o": draw.normal((d_model, d_model), sc, dtype),
        # data-dependent decay: w_t = exp(-exp(decay + lora(x)))
        "decay": draw.full((d_model,), -1.0, f32),
        "w_dd1": draw.normal((d_model, lora), sc, dtype),
        "w_dd2": draw.normal((lora, d_model), 0.1, dtype),
        "bonus": draw.normal((d_model,), 0.1, f32),
        "ln_x": draw.full((d_model,), 0.0, dtype),
        # channel mix
        "cmix_k": draw.full((d_model,), 0.5, dtype),
        "w_ck": draw.normal((d_model, d_ff), sc, dtype),
        "w_cv": draw.normal((d_ff, d_model), 1.0 / (d_ff ** 0.5), dtype),
        "w_cr": draw.normal((d_model, d_model), sc, dtype),
    }


def _token_shift(x, last=None):
    """Shift by one token: (B, T, D) -> previous token's activation."""
    B, T, D = x.shape
    prev = x.new_zeros((B, 1, D)) if last is None else last
    return torch.cat([prev, x[:, :-1]], dim=1)


def _wkv_heads(r, k, v, w, u, backend=None):
    """`ops.wkv6` on the (B, H, T, K) layout: r, k, v, w merged into (B*H,
    T, K) float32, u (H, K); returns (B, H, T, K) float32."""
    B, H, T, K = r.shape
    merge = lambda z: z.reshape(B * H, T, K).float()
    # K8 takes head bh to u's row bh % H, JAX's (B, H) -> B*H order
    out = ops.wkv6(merge(r), merge(k), merge(v), merge(w), u, backend=backend)
    return out.reshape(B, H, T, K)


def _local_wkv(placements: tuple, backend):
    """`_wkv_heads` under `local_map` at ``placements`` (of the (B, H, T,
    K) heads): each rank runs K8 on its own heads and batch rows.  u's
    gradient is a partial sum over the mesh dims that split the batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    pl = placements
    u_pl = tuple(Shard(0) if p == Shard(1) else Replicate() for p in pl)
    u_grad = tuple(Partial() if p == Shard(0) else q for p, q in zip(pl, u_pl))
    fn = lambda r, k, v, w, u: _wkv_heads(r, k, v, w, u, backend)
    return local_map(fn, out_placements=(pl,), in_placements=(pl,) * 4 + (u_pl,),
                     in_grad_placements=(pl,) * 4 + (u_grad,),
                     redistribute_inputs=True)


def time_mix(p, x, cfg: RwkvCfg, shift_state=None, wkv_state=None,
             backend=None, head_sharding=None):
    """x (B, T, D) -> (out, (new_shift, new_wkv)); states enable decode.

    With ``wkv_state`` None (prefill) the recurrence goes through
    `ops.wkv6` on ``backend`` in float32 and new_wkv is None.  On
    DTensors the (B, H, T, K) heads are pinned to ``head_sharding``
    (JAX pins the merged (B*H, T, K) tensors) and the recurrence runs
    under `local_map` at those placements (`layers.core_placements`),
    each rank on its own heads and rows."""
    B, T, D = x.shape
    H = cfg.n_heads(D)
    K = cfg.head_dim
    xs = _token_shift(x, shift_state)

    def mix(m):
        return x * m + xs * (1 - m)
    r, k, v = (tp_einsum("btd,de->bte", mix(p[f"mix_{n}"]), p[f"w_{n}"])
               for n in "rkv")
    xw = mix(p["mix_w"]).float()
    dd = (xw @ p["w_dd1"].float()) @ p["w_dd2"].float()
    w = torch.exp(-torch.exp(p["decay"][None, None] + dd))   # (B, T, D) in (0,1)

    def heads(z):
        """(B, T, D) -> (B*H, T, K) float32: head bh is (b, h), bh = b H + h."""
        return z.reshape(B, T, H, K).transpose(1, 2).reshape(B * H, T, K).float()
    u = p["bonus"].reshape(H, K)

    if wkv_state is None:
        h4 = [pin(z.reshape(B, T, H, K).transpose(1, 2), head_sharding)
              for z in (r, k, v, w.to(x.dtype))]
        wkv = (_local_wkv(core_placements(h4[0], head_sharding), backend)
               if is_dtensor(h4[0]) else
               lambda *a: _wkv_heads(*a, backend=backend))
        out = wkv(*h4, u).transpose(1, 2).reshape(B, T, D)
        new_wkv = None
    else:
        out, new_wkv = _wkv_with_state(heads(r), heads(k), heads(v),
                                       heads(w), u, wkv_state)
        out = out.reshape(B, H, T, K).transpose(1, 2).reshape(B, T, D)
    # group-norm-ish scale (float32) then output proj
    out = out * (1.0 + p["ln_x"])
    out = tp_einsum("btd,de->bte", out.to(x.dtype), p["w_o"])
    return out, (x[:, -1:], new_wkv)


def _wkv_with_state(r, k, v, w, u, S0):
    """WKV with an explicit initial state (decode path), float32: r, k, v, w
    (BH, T, K); u (H, K), head bh taking row bh % H; S0 (BH, K, K).
    Returns (out (BH, T, K), S_T)."""
    BH = r.shape[0]
    uh = u.repeat(BH // u.shape[0], 1) if u.dim() == 2 else u
    S = S0
    out = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, None] * v[:, t, None, :]
        out.append((r[:, t, :, None] * (S + uh[:, :, None] * kv)).sum(dim=1))
        S = w[:, t, :, None] * S + kv
    return torch.stack(out, dim=1), S


def _wkv_chunk(S, rc, kc, vc, wc, uh):
    """One chunk of `wkv_chunked`, float32: S (BH, K, V); rc, kc, wc (BH, C,
    K); vc (BH, C, V); uh (BH, K).  Returns (S after the chunk, out)."""
    BH, C, K = rc.shape
    L = torch.cumsum(torch.log(torch.clamp(wc, min=1e-30)), dim=1)
    Lprev = torch.cat([L.new_zeros((BH, 1, K)), L[:, :-1]], dim=1)
    # pairwise decay ratios: exp(L_{j-1} - L_i) for i < j (always <= 1)
    D = Lprev[:, :, None, :] - L[:, None, :, :]            # (BH, Cj, Ci, K)
    mask = torch.tril(torch.ones((C, C), dtype=torch.float32,
                                 device=rc.device), -1)
    P = torch.einsum("bjk,bik,bjik->bji", rc, kc,
                     torch.exp(torch.minimum(D, D.new_zeros(())))) * mask[None]
    intra = torch.einsum("bji,bik->bjk", P, vc)
    diag = torch.sum(rc * uh[:, None] * kc, dim=-1, keepdim=True) * vc
    r_t = rc * torch.exp(Lprev)                            # <= |r| (safe)
    inter = torch.einsum("bik,bkv->biv", r_t, S)
    out = inter + intra + diag
    aC = L[:, -1]                                          # (BH, K) log decay
    kS = kc * torch.exp(aC[:, None] - L)                   # exp(L_C - L_i) <= 1
    S_new = torch.exp(aC)[:, :, None] * S + torch.einsum("bik,biv->bkv", kS, vc)
    return S_new, out


def wkv_chunked(r, k, v, w, u, S0=None, chunk: int = 64):
    """Chunkwise-parallel WKV6 (JAX's `wkv_chunked`), float32.

    Within a chunk of C = min(chunk, T) steps, with L_t = cumsum(log w):
    intra-chunk ((r k^T) o exp(L_{j-1} - L_i), strictly lower) V, from the
    exact pairwise log-decay differences (every exp <= 1, safe for any
    decay), plus the bonus diag(r_j . (u o k_j)) v_j; inter-chunk r_j
    exp(L_{j-1}) S; the state S_C = diag(exp(L_C)) S + (k o exp(L_C -
    L_i))^T V.  A ragged last chunk is cut short (JAX needs T % C == 0).
    Under grad each chunk's body is checkpointed.

    r, k, w (BH, T, K); v (BH, T, V); u (BH, K) or (K,); S0 (BH, K, V) or
    None (zeros).  Returns (out (BH, T, V), S_T), float32.  On fake
    tensors (`launch/lm_dryrun.py`) one chunk stands for all
    (`layers.traced_chunks`)."""
    BH, T, K = r.shape
    C = min(chunk, T)
    uh = u.float() if u.dim() == 2 else u.float()[None].expand(BH, K)
    S = (r.new_zeros((BH, K, v.shape[-1]), dtype=torch.float32)
         if S0 is None else S0.float())
    n = T // C
    if ops.is_fake(r) and n > 1 and T % C == 0:
        # a dry run's trace: one chunk for all n (`layers.traced_chunks`);
        # the final state, which its caller drops, is S0's placeholder
        return traced_chunks(_wkv_chunk, n, C, S, *(z.float() for z in
                                                    (r, k, v, w)), uh), S
    outs = []
    for c0 in range(0, T, C):
        xs = [z[:, c0:c0 + C].float() for z in (r, k, v, w)]
        if torch.is_grad_enabled():
            S, out = checkpoint(_wkv_chunk, S, *xs, uh, use_reentrant=False)
        else:
            S, out = _wkv_chunk(S, *xs, uh)
        outs.append(out)
    return torch.cat(outs, dim=1), S


class WKV6(torch.autograd.Function):
    """The WKV recurrence with a gradient: forward `ops.wkv6` on ``backend``
    (``plain`` or ``cuda``: K8), backward the gradient of `wkv_chunked`
    recomputed from the saved inputs.  u (K,) or (H, K), head bh taking row
    bh % H."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, backend):
        ctx.save_for_backward(r, k, v, w, u)
        return ops.wkv6(r, k, v, w, u, backend=backend)

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad(), annotate("rwkv.wkv_backward"):
            xs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            r, k, v, w, u = xs
            uh = u.repeat(r.shape[0] // u.shape[0], 1) if u.dim() == 2 else u
            out, _ = wkv_chunked(r, k, v, w, uh)
            grads = torch.autograd.grad(out, xs, dout.to(out.dtype))
        return (*grads, None)


def channel_mix(p, x, shift_state=None):
    xs = _token_shift(x, shift_state)
    xk = x * p["cmix_k"] + xs * (1 - p["cmix_k"])
    h = torch.square(F.relu(tp_einsum("btd,df->btf", xk, p["w_ck"])))
    r = torch.sigmoid(tp_einsum("btd,de->bte", x, p["w_cr"]))
    return r * tp_einsum("btf,fd->btd", h, p["w_cv"]), x[:, -1:]


def init_rwkv_state(batch, d_model, cfg: RwkvCfg, dtype=torch.bfloat16,
                    device="cpu"):
    H = cfg.n_heads(d_model)
    return {
        "tm_shift": torch.zeros((batch, 1, d_model), dtype=dtype, device=device),
        "cm_shift": torch.zeros((batch, 1, d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((batch * H, cfg.head_dim, cfg.head_dim),
                           dtype=torch.float32, device=device),
    }
