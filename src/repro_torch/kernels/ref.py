"""Plain references of the kernels: the `ref` backend of the cell-layout
ops and of the model ops in `ops.py` (the counterparts of the JAX package's
`kernels/ref.py`).

Each function computes what its kernel computes, in the kernel's shapes,
from the column solvers of `core/` or from a textbook form (a per-step
scan, dense or doubly blocked softmax) rather than from the kernel's own
plain version, so that `ref` and `plain` are two independent forms.
"""
from __future__ import annotations

import torch

from ..core import layout


def tridiag(dl, d, du, b):
    """Thomas solve, (nl, C) operands; see kernels/tridiag.py."""
    from ..core.turbulence import thomas_solve
    return thomas_solve(dl, d, du, b)


def _minv_faces(F, area):
    """M_h^{-1} of the top and bottom faces of F (nl*6, C), area (1, C)."""
    rows, C = F.shape
    Ff = F.reshape(rows // 6, 6, C)
    inva = 12.0 / area

    def minv(face):
        # face (nl, 3, C): M_h^{-1} mixes the 3 nodes of each face
        return inva * (face - 0.25 * face.sum(dim=1, keepdim=True))
    return minv(Ff[:, 0:3, :]), minv(Ff[:, 3:6, :])


def solve_r_cell(F, area, r_surf):
    """Matrix-free D_vu solve in cell layout: F (nl*6, C), area (1, C),
    r_surf (3, C)."""
    gt, gb = _minv_faces(F, area)
    rb = r_surf[None] - torch.cumsum(gt + gb, dim=0)
    return torch.cat([rb + 2.0 * gb, rb], dim=1).reshape(F.shape)


def solve_w_cell(F, area, w_floor):
    """Matrix-free D_vd solve in cell layout: F (nl*6, C), area (1, C),
    w_floor (3, C)."""
    gt, gb = _minv_faces(F, area)
    s = torch.flip(torch.cumsum(torch.flip(gt + gb, [0]), dim=0), [0])
    wt = w_floor[None] + s
    return torch.cat([wt, wt - 2.0 * gt], dim=1).reshape(F.shape)


def block_thomas_cell(lo, dg, up, b):
    """Block-tridiagonal solve: lo/dg/up (nl, 6, 6, C), b (nl, 6, k, C)."""
    from ..core.vertical import Blocks, block_thomas_solve
    rhs = torch.movedim(b, 2, 0)               # (k, nl, 6, C)
    x = block_thomas_solve(Blocks(lo=lo, dg=dg, up=up), rhs)
    return torch.movedim(x, 0, 2)


def soa_to_cell(x):
    """(nl, 6, nt) -> (nc, nl*6, 128)."""
    return layout.soa_to_cell(x)


def cell_to_soa(x, nt):
    """(nc, nl*6, 128) -> (nl, 6, nt)."""
    _, rows, _ = x.shape
    return layout.cell_to_soa(x, rows // 6, 6, nt)


# ---------------------------------------------------------------------------
# model kernels (the JAX package's `kernels/ref.py:108-192`)
# ---------------------------------------------------------------------------
NEG_INF = -1e30


def wkv6(r, k, v, w, u):
    """RWKV6 recurrence as a scan over time, all heads at once: r, k, w
    (BH, T, K), v (BH, T, V), u (K,) or (H, K), head bh taking row bh % H
    (as JAX `models/rwkv.py::_wkv_with_state` repeats it).  S is float32;
    like the JAX form, the result is float32 whatever the inputs' dtype."""
    BH, T, K = r.shape
    S = torch.zeros((BH, K, v.shape[-1]), dtype=torch.float32, device=r.device)
    uu = u[:, None] if u.dim() == 1 else u.repeat(BH // u.shape[0], 1)[:, :, None]
    out = []
    for t in range(T):
        kv = k[:, t, :, None] * v[:, t, None, :]
        out.append((r[:, t, :, None] * (S + uu * kv)).sum(dim=1))
        S = w[:, t, :, None] * S + kv
    return torch.stack(out, dim=1)


def _mask(q_ids, k_ids, causal, window):
    mask = torch.ones(torch.broadcast_shapes(q_ids.shape, k_ids.shape),
                      dtype=torch.bool, device=q_ids.device)
    if causal:
        mask = mask & (k_ids <= q_ids)
    if window is not None:
        mask = mask & (k_ids > q_ids - window)
    return mask


def attention(q, k, v, causal=True, window=None, softcap=None):
    """Dense softmax attention: q (BH, Tq, d), k/v (BH, Tk, d)."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q, k).float() / (d ** 0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    dev = q.device
    mask = _mask(torch.arange(q.shape[1], device=dev)[:, None],
                 torch.arange(k.shape[1], device=dev)[None, :], causal, window)
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v)


def chunked_attention(q, k, v, causal=True, window=None, softcap=None,
                      chunk: int = 1024, q_block: int = 512):
    """Doubly blocked online-softmax attention in float32: query blocks of
    q_block rows, each scanning KV chunks of `chunk` keys (the JAX package's
    CPU fallback).  Tq and Tk must be multiples of the block sizes, which
    are cut to Tq and Tk when those are shorter."""
    BH, Tq, d = q.shape
    Tk = k.shape[1]
    ck, qb = min(chunk, Tk), min(q_block, Tq)
    if Tk % ck or Tq % qb:
        raise ValueError(f"chunked_attention: Tq={Tq}, Tk={Tk} are not "
                         f"multiples of q_block={qb}, chunk={ck}")
    dev = q.device
    qs = q.float() / (d ** 0.5)
    out = []
    for i0 in range(0, Tq, qb):
        qc = qs[:, i0:i0 + qb]
        q_ids = i0 + torch.arange(qb, device=dev)[:, None]
        m = torch.full((BH, qb, 1), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((BH, qb, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((BH, qb, d), dtype=torch.float32, device=dev)
        for j0 in range(0, Tk, ck):
            s = torch.einsum("bqd,bkd->bqk", qc, k[:, j0:j0 + ck].float())
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            k_ids = j0 + torch.arange(ck, device=dev)[None, :]
            s = torch.where(_mask(q_ids, k_ids, causal, window)[None], s,
                            NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = alpha * acc + torch.einsum("bqk,bkd->bqd", p,
                                             v[:, j0:j0 + ck].float())
            m = m_new
        out.append(acc / torch.clamp(l, min=1e-30))
    return torch.cat(out, dim=1).to(q.dtype)
