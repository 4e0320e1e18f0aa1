"""Flash attention of the LM on the (B, H, T, d) layout (the JAX package's
`models/attention.py`: `flash_attention_xla`, its forward, and the custom
VJP's `_bwd_rule`, its backward).

The heads merge with the batch into K9's (B*H, T, d) layout, contiguous,
and `ops.attention` computes the masked online softmax: causal, the
sliding window ``k > q - window`` and the soft-cap after the scale, with
the output in q's dtype.

Gradients.  When q, k or v require grad, `ops.attention` on the ``plain``
and ``cuda`` backends goes through `FlashAttention`, a
`torch.autograd.Function`: its forward is `ops.attention_with_stats` (K9
on the card, `flash_attention_plain` on the CPU), which also returns the
row statistics m and l; it saves (q, k, v, out, m, l), as JAX's
`_fwd_rule` does, and its backward is `flash_attention_bwd`, the port of
`_bwd_rule` in plain torch matmuls (JAX computes it in XLA, outside any
Pallas kernel): two passes that recompute the scores block by block, dq
with the query blocks outer and dk / dv with the key blocks outer, so no
(Tq, Tk) tensor is ever whole.  On ``ref`` autograd runs through the
reference's own chunked softmax.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import dispatch, ops
from ..obs.trace import annotate

NEG = -1e30
Q_BLOCK, K_BLOCK = 512, 1024      # flash_attention_xla's q_block, k_block


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    backend: dispatch.BackendLike = None) -> torch.Tensor:
    """q (B, H, Tq, d), k / v (B, H, Tk, d) -> (B, H, Tq, d) in q's dtype."""
    B, H, Tq, d = q.shape
    merge = lambda z: z.reshape(B * H, z.shape[2], d).contiguous()
    out = ops.attention(merge(q), merge(k), merge(v), causal=causal,
                        window=window, softcap=softcap, backend=backend)
    return out.reshape(B, H, Tq, d)


def _mask(q0: int, k0: int, nq: int, nk: int, causal: bool, window,
          device) -> torch.Tensor:
    """(nq, nk) validity of the keys k0.. for the queries q0.. (JAX's
    `_mask`)."""
    q_ids = q0 + torch.arange(nq, device=device)[:, None]
    k_ids = k0 + torch.arange(nk, device=device)[None, :]
    m = torch.ones((nq, nk), dtype=torch.bool, device=device)
    if causal:
        m = m & (k_ids <= q_ids)
    if window is not None:
        m = m & (k_ids > q_ids - window)
    return m


def flash_attention_bwd(q, k, v, out, m, l, dout, causal=True, window=None,
                        softcap=None, q_block: int = Q_BLOCK,
                        k_block: int = K_BLOCK):
    """JAX's `_bwd_rule`: q, out, dout (..., Tq, d); k, v (..., Tk, d); m, l
    float32 (..., Tq), the forward's row statistics.  Returns (dq, dk, dv)
    in the dtypes of q, k and v.

    Per block of qb = min(q_block, Tq) queries and ck = min(k_block, Tk)
    keys the scores are recomputed in float32 from q * d^-1/2, soft-capped
    (t = tanh(s / softcap)), masked to -1e30, and p = exp(s - m) / max(l,
    1e-30); ds = p (dout v^T - Dsum), with Dsum = sum(dout * out) per row,
    times (1 - t^2) under the soft-cap, and zero where masked.  Pass 1
    sums dq = ds k d^-1/2 over the key blocks of each query block; pass 2
    sums dk = ds^T (q d^-1/2) and dv = p^T dout over the query blocks of
    each key block.  Any Tq and Tk: a ragged last block is cut short (JAX
    needs multiples of the blocks)."""
    Tq, d = q.shape[-2:]
    Tk = k.shape[-2]
    qb, ck = min(q_block, Tq), min(k_block, Tk)
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    m, l = m[..., None], l[..., None]
    Dsum = (dout.float() * out.float()).sum(dim=-1, keepdim=True)

    def block_grads(i0, j0, dc):
        """(ds, p, k block, q block * scale) of block (i0, j0)."""
        qcf = q[..., i0:i0 + qb, :].float() * scale
        kc = k[..., j0:j0 + ck, :].float()
        vc = v[..., j0:j0 + ck, :].float()
        s = torch.matmul(qcf, kc.transpose(-1, -2))
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = softcap * t
        msk = _mask(i0, j0, qcf.shape[-2], kc.shape[-2], causal, window, dev)
        s = torch.where(msk, s, NEG)
        p = torch.exp(s - m[..., i0:i0 + qb, :]) / torch.clamp(
            l[..., i0:i0 + qb, :], min=1e-30)
        dp = torch.matmul(dc, vc.transpose(-1, -2))
        ds = p * (dp - Dsum[..., i0:i0 + qb, :])
        if softcap is not None:
            ds = ds * (1.0 - t * t)
        ds = torch.where(msk, ds, 0.0)
        return ds, p, kc, qcf

    # pass 1: dq, query blocks outer
    dq = []
    for i0 in range(0, Tq, qb):
        dc = dout[..., i0:i0 + qb, :].float()
        acc = None
        for j0 in range(0, Tk, ck):
            ds, _, kc, _ = block_grads(i0, j0, dc)
            term = torch.matmul(ds, kc) * scale
            acc = term if acc is None else acc + term
        dq.append(acc)
    # pass 2: dk / dv, key blocks outer, query blocks inner
    dk, dv = [], []
    for j0 in range(0, Tk, ck):
        dk_j = dv_j = None
        for i0 in range(0, Tq, qb):
            dc = dout[..., i0:i0 + qb, :].float()
            ds, p, _, qcf = block_grads(i0, j0, dc)
            tk = torch.matmul(ds.transpose(-1, -2), qcf)
            tv = torch.matmul(p.transpose(-1, -2), dc)
            dk_j = tk if dk_j is None else dk_j + tk
            dv_j = tv if dv_j is None else dv_j + tv
        dk.append(dk_j)
        dv.append(dv_j)
    return (torch.cat(dq, dim=-2).to(q.dtype), torch.cat(dk, dim=-2).to(k.dtype),
            torch.cat(dv, dim=-2).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: forward `ops.attention_with_stats` on
    ``backend`` (``plain`` or ``cuda``), backward `flash_attention_bwd`.
    q (BH, Tq, d), k / v (BH, Tk, d)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, backend):
        out, m, l = ops.attention_with_stats(q, k, v, causal=causal,
                                             window=window, softcap=softcap,
                                             backend=backend)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.opts = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        with annotate("attention.backward"):
            dq, dk, dv = flash_attention_bwd(q, k, v, out, m, l, dout,
                                             *ctx.opts)
        return dq, dk, dv, None, None, None, None
