"""Vertical (column) solvers — the computational heart of the paper.

1. Matrix-free solvers (paper §2.3, Algorithm 1): the systems for the
   hydrostatic pressure gradient r (D_vu r = F) and the vertical velocity w
   (D_vd w = F) reduce, after applying M_h^{-1} per face, to prefix sums
   over layers:

     r_b^l = r_surf - sum_{k<=l}(g_t^k + g_b^k),   r_t^l = r_b^l + 2 g_b^l
     w_t^l = w_floor + sum_{k>=l}(g_t^k + g_b^k),  w_b^l = w_t^l - 2 g_t^l

   Here they are cumsums over the layer axis: the `ref` backend.  The CUDA
   sweeps are in `kernels/matrix_free.py`.

2. Fully-assembled column operator (paper §2.4): implicit vertical
   advection + viscosity couples each prism's 6 nodes to the prisms above
   and below -> block-tridiagonal with 6x6 blocks.  (L, D, U) blocks are
   assembled here and solved by a block-Thomas elimination over layers,
   batched over all columns (`block_thomas_solve`, the `ref` backend; the
   CUDA kernel is in `kernels/column_solve.py`).  The same blocks give the
   explicit matvec F_3D^v(u) for fully-explicit sub-steps.

All 'weighted mass' face integrals use the shared 3-point quadrature of
`geometry` so that discrete consistency holds across every operator.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import geometry as G
from ..obs import trace
from .geometry import PHI_VQ, lincomb

# vertical P1 mass on [-1,1]: int phi_a phi_b dzeta
MZ = np.array([[2.0 / 3.0, 1.0 / 3.0], [1.0 / 3.0, 2.0 / 3.0]])
# d/dzeta of (top, bottom) vertical basis
SZ = np.array([0.5, -0.5])
# vertical basis at the 2 Gauss points (qz, [top,bot])
PHI_Z = G.PHI_ZQ


def _minv_faces(geom: G.Geom2D, F: torch.Tensor) -> torch.Tensor:
    """Apply M_h^{-1} to the two 3-node faces of (..., nl, 6, nt)."""
    gt = G.minv_apply(geom, F[..., 0:3, :])
    gb = G.minv_apply(geom, F[..., 3:6, :])
    return torch.cat([gt, gb], dim=-2)


def solve_r(geom: G.Geom2D, F: torch.Tensor,
            r_surf: torch.Tensor) -> torch.Tensor:
    """Matrix-free top-down solve of D_vu r = F (paper Alg. 1).

    F: (..., nl, 6, nt) assembled RHS (interior terms only);
    r_surf: (..., 3, nt) Dirichlet surface value (paper eq. 8 on Gamma_s)."""
    g = _minv_faces(geom, F)
    s = torch.cumsum(g[..., 0:3, :] + g[..., 3:6, :], dim=-3)
    r_b = r_surf[..., None, :, :] - s
    r_t = r_b + 2.0 * g[..., 3:6, :]
    return torch.cat([r_t, r_b], dim=-2)


def solve_w(geom: G.Geom2D, F: torch.Tensor,
            w_floor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Matrix-free bottom-up solve of D_vd w = F.

    w_floor: (..., 3, nt) bottom impermeability value (None: 0)."""
    g = _minv_faces(geom, F)
    gsum = g[..., 0:3, :] + g[..., 3:6, :]
    s = torch.flip(torch.cumsum(torch.flip(gsum, [-3]), dim=-3), [-3])
    w_t = s if w_floor is None else w_floor[..., None, :, :] + s
    w_b = w_t - 2.0 * g[..., 0:3, :]
    return torch.cat([w_t, w_b], dim=-2)


# ---------------------------------------------------------------------------
# Weighted 3x3 horizontal mass blocks:  WM[g]_ij = sum_q (A/3) phi_i phi_j g_q
# ---------------------------------------------------------------------------
def wmass(geom: G.Geom2D, g_qp: torch.Tensor) -> torch.Tensor:
    """g at volume qps (..., 3, nt) -> blocks (..., 3, 3, nt)."""
    xs = [g_qp[..., q, :] for q in range(3)]
    rows = [torch.stack([lincomb(PHI_VQ[:, i] * PHI_VQ[:, j], xs)
                         for j in range(3)], dim=-2) for i in range(3)]
    return torch.stack(rows, dim=-3) * (geom.area / 3.0)


def wmass_apply(geom: G.Geom2D, g_qp: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """WM[g] @ v without materialising blocks: v (..., 3, nt)."""
    return G.vol_scatter(geom, g_qp * G.vol_interp(v))


# ---------------------------------------------------------------------------
# Block-tridiagonal column operator
# ---------------------------------------------------------------------------
class Blocks(NamedTuple):
    """Column operator blocks, each (nl, 6, 6, nt).

    lo[l] couples layer l to layer l-1 (above), up[l] to layer l+1 (below).
    lo[0] and up[nl-1] are zero."""
    lo: torch.Tensor
    dg: torch.Tensor
    up: torch.Tensor


def mass_blocks(geom: G.Geom2D, jz: torch.Tensor, nl: int) -> torch.Tensor:
    """3D prism mass matrix blocks (block-diagonal): (nl, 6, 6, nt).

    M = MZ (x) WM[jz]; jz (3, nt) is constant over layers (sigma grid)."""
    wm = wmass(geom, G.vol_interp(jz))              # (3, 3, nt)
    blk = torch.cat([torch.cat([float(MZ[a, b]) * wm for b in range(2)],
                               dim=1) for a in range(2)], dim=0)
    return blk[None].expand(nl, 6, 6, blk.shape[-1])


def mass_apply3d(geom: G.Geom2D, jz: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """M u for 3D fields (..., nl, 6, nt) without materialising blocks."""
    ut, ub = u[..., 0:3, :], u[..., 3:6, :]
    jz_q = G.vol_interp(jz)
    wm_t = wmass_apply(geom, jz_q, MZ[0, 0] * ut + MZ[0, 1] * ub)
    wm_b = wmass_apply(geom, jz_q, MZ[1, 0] * ut + MZ[1, 1] * ub)
    return torch.cat([wm_t, wm_b], dim=-2)


def mass_solve3d(geom: G.Geom2D, jz: torch.Tensor,
                 r: torch.Tensor) -> torch.Tensor:
    """M^{-1} r: MZ^{-1} (x) WM[jz]^{-1}; WM[jz]^{-1} via batched 3x3 solve."""
    with trace.annotate("vertical.mass_solve3d", profiler=False):
        rt, rb = r[..., 0:3, :], r[..., 3:6, :]
        st = 2.0 * rt - rb                       # MZ^{-1} = [[2,-1],[-1,2]]
        sb = -rt + 2.0 * rb
        wmT = wmass(geom, G.vol_interp(jz)).permute(2, 0, 1)   # (nt, 3, 3)

        def solve3(v):
            vT = v.movedim(-1, -2)                   # (..., nt, 3)
            out = torch.linalg.solve(wmT, vT[..., None])[..., 0]
            return out.movedim(-1, -2)
        return torch.cat([solve3(st), solve3(sb)], dim=-2)


def sigma3_horizontal(geom: G.Geom2D, H: torch.Tensor, nl: int,
                      N0: float = 5.0, o: int = 1, d: int = 3) -> torch.Tensor:
    """Interior-penalty coefficient on horizontal faces (paper eq. 19):
    sigma_d = N0(o+1)(o+d) / (2 d L), L = average prism height."""
    L = H / nl
    return N0 * (o + 1) * (o + d) / (2.0 * d * L)


def assemble_vertical_operator(
        geom: G.Geom2D,
        nl: int,
        jz: torch.Tensor,           # (3, nt)
        wrel_nodes: torch.Tensor,   # (nl, 6, nt): w~ - w_m at prism nodes
        wface: torch.Tensor,        # (nl+1, 3, nt): advective speed at interfaces
        kappa: torch.Tensor,        # (nl, 6, nt): implicit vertical visc/diff
        H: torch.Tensor,            # (3, nt) for the penalty length scale
        drag_coeff: Optional[torch.Tensor] = None,  # (3, nt) bottom drag
        ) -> Blocks:
    """Assemble F_3D^v as block-tridiagonal blocks (paper eq. 18).

    Sign convention: F_3D^v(u) = (lo, dg, up) @ u appears on the RHS of the
    momentum/tracer equations; the implicit system is (M - dt*A) u1 = rhs.
    The blocks are accumulated in place."""
    nt = jz.shape[-1]
    z = dict(dtype=jz.dtype, device=jz.device)
    dg = torch.zeros((nl, 6, 6, nt), **z)
    lo = torch.zeros((nl, 6, 6, nt), **z)
    up = torch.zeros((nl, 6, 6, nt), **z)
    jz_q = G.vol_interp(jz)                         # (3qp, nt)

    def wm(g_qp):                                   # (..., 3qp, nt)->(...,3,3,nt)
        return wmass(geom, g_qp)

    # --- 1. advection volume: + s_a * sum_qz phi_z^b(qz) WM[wrel(qz)] -------
    wt_q = G.vol_interp(wrel_nodes[:, 0:3, :])      # (nl, 3qp, nt)
    wb_q = G.vol_interp(wrel_nodes[:, 3:6, :])
    for iz in range(2):
        blk = wm(PHI_Z[iz, 0] * wt_q + PHI_Z[iz, 1] * wb_q)
        for a in range(2):
            for b_ in range(2):
                coef = float(SZ[a] * PHI_Z[iz, b_])
                dg[:, 3 * a:3 * a + 3, 3 * b_:3 * b_ + 3, :] += coef * blk

    # --- 3. viscosity volume: - s_a s_b WM[sum_qz kappa(qz)/jz] -------------
    kt_q = G.vol_interp(kappa[:, 0:3, :])
    kb_q = G.vol_interp(kappa[:, 3:6, :])
    ksum_q = ((PHI_Z[0, 0] + PHI_Z[1, 0]) * kt_q
              + (PHI_Z[0, 1] + PHI_Z[1, 1]) * kb_q)
    blk_visc = wm(ksum_q / jz_q)
    for a in range(2):
        for b_ in range(2):
            dg[:, 3 * a:3 * a + 3, 3 * b_:3 * b_ + 3, :] += (
                float(-SZ[a] * SZ[b_]) * blk_visc)

    # --- interface terms (k = 1..nl-1 interior) ------------------------------
    Wq = G.vol_interp(wface)                        # (nl+1, 3qp, nt)
    up_mask = (Wq > 0).to(jz.dtype)                 # upwind = from below
    k_bot_above = kb_q                              # (nl, 3qp, nt) own bottom
    k_top_below = kt_q                              # (nl, 3qp, nt) own top
    sig = G.vol_interp(sigma3_horizontal(geom, H, nl))

    # interior interfaces k=1..nl-1: between layer k-1 (above) and k (below)
    Wk = Wq[1:nl]
    upk = up_mask[1:nl]
    blk_below = wm(Wk * upk)                        # coupling to u_{k, top}
    blk_above = wm(Wk * (1 - upk))                  # coupling to u_{k-1, bot}
    dg[1:, 0:3, 0:3, :] -= blk_below
    lo[1:, 0:3, 3:6, :] -= blk_above
    up[:-1, 3:6, 0:3, :] += blk_below
    dg[:-1, 3:6, 3:6, :] += blk_above

    # surface interface k=0: u^up == interior (layer 0 top) for both signs
    dg[0, 0:3, 0:3, :] -= wm(Wq[0])
    # floor interface k=nl (speed 0 by impermeability; assembled anyway)
    dg[nl - 1, 3:6, 3:6, :] += wm(Wq[nl])

    # viscosity consistency at interior interfaces
    kb = wm(k_bot_above[:nl - 1] / jz_q / 4.0)
    kt = wm(k_top_below[1:] / jz_q / 4.0)
    dg[1:, 0:3, 0:3, :] += kt
    dg[1:, 0:3, 3:6, :] -= kt
    lo[1:, 0:3, 0:3, :] += kb
    lo[1:, 0:3, 3:6, :] -= kb
    up[:-1, 3:6, 0:3, :] -= kt
    up[:-1, 3:6, 3:6, :] += kt
    dg[:-1, 3:6, 0:3, :] -= kb
    dg[:-1, 3:6, 3:6, :] += kb

    # interior penalty: -sigma {kappa} [[u]] on interface k
    kmean = 0.5 * (k_bot_above[:nl - 1] + k_top_below[1:])
    pen = wm(sig * kmean) * 0.5                     # the [[.]] carries 1/2
    dg[1:, 0:3, 0:3, :] -= pen
    lo[1:, 0:3, 3:6, :] += pen
    dg[:-1, 3:6, 3:6, :] -= pen
    up[:-1, 3:6, 0:3, :] += pen

    # bottom drag (momentum): - WM[Cd|u|] on the floor nodes
    if drag_coeff is not None:
        dg[nl - 1, 3:6, 3:6, :] -= wm(G.vol_interp(drag_coeff))

    return Blocks(lo=lo, dg=dg, up=up)


def implicit_system(M_blocks: torch.Tensor, A: Blocks, dtau: float) -> Blocks:
    """The vertically-implicit system (M - dt A) as Blocks."""
    return Blocks(lo=-dtau * A.lo, dg=M_blocks - dtau * A.dg,
                  up=-dtau * A.up)


def _bmv(blk: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Per-column block matvec: blk (l, 6, 6, nt), u (..., l, 6, nt)."""
    return (blk * u[..., None, :, :]).sum(dim=-2)


def blocks_matvec(blocks: Blocks, u: torch.Tensor) -> torch.Tensor:
    """Apply the block-tridiagonal operator: u (..., nl, 6, nt)."""
    lo, dg, up = blocks
    out = _bmv(dg, u)
    out[..., 1:, :, :] += _bmv(lo[1:], u[..., :-1, :, :])
    out[..., :-1, :, :] += _bmv(up[:-1], u[..., 1:, :, :])
    return out


def block_thomas_solve(blocks: Blocks, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the block-tridiagonal system; rhs (k, nl, 6, nt) for k RHS
    components (momentum solves u,v together; tracers T,S together).

    Forward elimination over layers with batched 6x6 LU solves over
    columns (`torch.linalg.solve`): the `ref` backend, and the oracle of
    the CUDA kernel in `kernels/column_solve.py` (paper §2.4)."""
    lo, dg, up = blocks
    k, nl, _, nt = rhs.shape
    loT = lo.permute(0, 3, 1, 2)                     # (nl, nt, 6, 6)
    dgT = dg.permute(0, 3, 1, 2)
    upT = up.permute(0, 3, 1, 2)
    bT = rhs.permute(1, 3, 2, 0)                     # (nl, nt, 6, k)
    C = torch.zeros((nt, 6, 6), dtype=rhs.dtype, device=rhs.device)
    y = torch.zeros((nt, 6, k), dtype=rhs.dtype, device=rhs.device)
    Cs, ys = [], []
    for l in range(nl):
        L = loT[l]
        S = dgT[l] - L @ C
        Cy = torch.linalg.solve(S, torch.cat([upT[l], bT[l] - L @ y], dim=-1))
        C, y = Cy[..., :6], Cy[..., 6:]
        Cs.append(C)
        ys.append(y)
    x = ys[-1]
    xs = [x]
    for l in range(nl - 2, -1, -1):
        x = ys[l] - Cs[l] @ x
        xs.append(x)
    xs = torch.stack(xs[::-1])                       # (nl, nt, 6, k)
    return xs.permute(3, 0, 2, 1).contiguous()


def blocks_dense(blocks: Blocks) -> torch.Tensor:
    """Materialise (nt, nl*6, nl*6) dense matrices (tests only)."""
    lo, dg, up = blocks
    nl, _, _, nt = dg.shape
    A = dg.new_zeros((nt, nl * 6, nl * 6))
    for l in range(nl):
        r = slice(l * 6, (l + 1) * 6)
        A[:, r, r] = dg[l].permute(2, 0, 1)
        if l > 0:
            A[:, r, (l - 1) * 6:l * 6] = lo[l].permute(2, 0, 1)
        if l < nl - 1:
            A[:, r, (l + 1) * 6:(l + 2) * 6] = up[l].permute(2, 0, 1)
    return A
