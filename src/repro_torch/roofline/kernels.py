"""Bytes and operations of each kernel's call, from its operands.

One function a kernel, taking the operands its body takes (`kernels/ops.py`
hands them over; `chip_smoke.py` bounds each kernel by them).  Bytes are
the compulsory traffic: each input read once and each output written once,
whatever the kernel reads again; operations are the arithmetic the column
algorithm needs.  A kernel's bound on a machine is the larger of bytes over
its HBM rate and operations over its peak for the dtype
(`roofline/analysis.py`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class Cost(NamedTuple):
    bytes: int
    flops: int


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def solve_r(F: torch.Tensor, area: torch.Tensor, bc: torch.Tensor) -> Cost:
    """K1, the top-down matrix-free sweep: F (K, nl, 6, nt), area (nt,),
    bc (K, 3, nt) read, F's shape written; 34 operations a layer and
    column and one at the surface, per component."""
    K, nl, _, nt = F.shape
    return Cost(nbytes(F, area, bc, F), K * nt * (nl * 34 + 1))


def solve_w(F: torch.Tensor, area: torch.Tensor,
            bc: Optional[torch.Tensor] = None) -> Cost:
    """K2, the bottom-up sweep: as K1, with no floor values to read when
    the floor is impermeable (``bc`` None)."""
    K, nl, _, nt = F.shape
    ins = (F, area) if bc is None else (F, area, bc)
    return Cost(nbytes(*ins, F), K * nt * (nl * 34 + 1))


def block_thomas(lo: torch.Tensor, dg: torch.Tensor, up: torch.Tensor,
                 rhs: torch.Tensor) -> Cost:
    """K3: the blocks the solve uses (lo but its first layer, dg, up but
    its last layer) and rhs (k, nl, 6, nt) read once, x written once; the
    elimination's S_l and right-hand side, six Gauss-Jordan steps, and the
    backward sweep."""
    k, nl, _, nt = rhs.shape
    per_layer = 36 * 13 + 6 * k * 13 + 6 * (133 + 11 * k)
    flops = nt * (nl * per_layer + (nl - 1) * 6 * k * 13)
    return Cost(nbytes(lo[1:], dg, up[:-1], rhs, rhs), flops)


def lateral_flux(f: torch.Tensor, fext: torch.Tensor, speed: torch.Tensor,
                 edge_len: torch.Tensor) -> Cost:
    """K4: f (k, nl, 6, nt), fext (k, nl, 3, 2, 2, nt), speed (nl, 2, 3, 2,
    nt) and edge_len (3, nt) read, f's shape written; 300 operations a
    layer, column and component."""
    k, nl, _, nt = f.shape
    return Cost(nbytes(f, fext, speed, edge_len, f), k * nl * nt * 300)


def tridiag(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
            b: torch.Tensor) -> Cost:
    """K7: the three bands and b (nl, C) read, x written; 8 operations a
    layer and column."""
    return Cost(nbytes(dl, d, du, b, b), 8 * d.numel())


def soa_to_cell(x: torch.Tensor) -> Cost:
    """K5: x (nl, 6, nt) read, (ceil(nt / 128), nl * 6, 128) written."""
    nl, six, nt = x.shape
    return Cost(nbytes(x) + -(-nt // 128) * nl * six * 128 * x.element_size(), 0)


def cell_to_soa(cells: torch.Tensor, nt: int) -> Cost:
    """K6: the nt live columns of cells (nc, nl * 6, 128) read, (nl, 6, nt)
    written."""
    return Cost(2 * cells.shape[1] * nt * cells.element_size(), 0)


def attention_pairs(Tq: int, Tk: int, causal: bool,
                    window: Optional[int]) -> int:
    """Unmasked (query, key) pairs of one head: query i sees the keys j <
    Tk with j <= i (causal) and j > i - window.  (Plain integers: the dry
    run computes this while fake tensors are active.)"""
    i = np.arange(Tq, dtype=np.int64)
    hi = np.minimum(i, Tk - 1) if causal else np.full(Tq, Tk - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(Tq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    stats: bool = False) -> Cost:
    """K9: q (BH, Tq, d), k and v (BH, Tk, d) read, the output (q's shape)
    and with ``stats`` m and l (float32 (BH, Tq)) written; 4 d operations
    an unmasked (query, key) pair (the two products), the window respected
    and the key tiles the kernel skips not counted."""
    BH, Tq, d = q.shape
    out = nbytes(q) + (2 * BH * Tq * 4 if stats else 0)
    return Cost(nbytes(q, k, v) + out,
                4 * d * BH * attention_pairs(Tq, k.shape[1], causal, window))


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor) -> Cost:
    """K8: r, k, w (BH, T, K), v (BH, T, V) and u read, the output (v's
    shape) written; 5 K V + 3 K + 2 V operations a token and head (k v,
    r S and w S + k v an element of S; the bonus sum r u k and its
    product with v)."""
    BH, T, K = r.shape
    V = v.shape[-1]
    return Cost(nbytes(r, k, v, w, u, v), (5 * K * V + 3 * K + 2 * V) * T * BH)


# the formula of each kernel, by the name `kernels/ops.py` counts it under
COST = {"solve_r": solve_r, "solve_w": solve_w, "block_thomas": block_thomas,
        "lateral_flux": lateral_flux, "tridiag": tridiag,
        "soa_to_cell": soa_to_cell, "cell_to_soa": cell_to_soa,
        "flash_attention": flash_attention, "wkv6": wkv6}
