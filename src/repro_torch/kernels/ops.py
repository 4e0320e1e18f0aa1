"""Entry points of the kernels, with backend dispatch.

Each op routes by `dispatch.Backend`:

  * ref   — the plain column solvers of `core/` (`kernels/ref.py` for the
            cell-layout ops and the model ops),
  * plain — the kernel's plain PyTorch version (same shapes as the kernel),
  * cuda  — the hand-written CUDA kernel.

Three families of signatures, as in the JAX package:

  * SoA (the stepper's hot path): `solve_r`, `solve_w`, `block_thomas`,
    `lateral_flux_term` take the stepper's (..., nl, 6, nt) tensors; a
    leading component axis is part of the kernel's thread index, so no
    fold / tile copies are made.
  * cell layout: `tridiag`, `solve_r_cell`, `solve_w_cell`,
    `block_thomas_cell` take (rows, C) column operands, and `soa_to_cell` /
    `cell_to_soa` convert a field between the layouts.  (nl*6, C) row-major
    is (nl, 6, C), so the matrix-free kernels take it as a view.
  * model ops: `wkv6` and `attention` (the JAX package's `ops.py:219-240`),
    whose `auto` is `cuda` on a CUDA tensor and `ref` on a CPU tensor
    (`dispatch.resolve_model`); with inputs that require grad they go
    through the `autograd.Function`s of `models/` (`attention_with_stats`
    gives the attention's forward its row statistics).

Every call goes through `_dispatch(op, backend)`, which adds one to the
default metrics registry's ``kernel_dispatch{op=..., backend=...}`` counter
and opens the span ``kops.<op>.<backend>`` (`obs/trace.py`): a range on a
profiler's timeline only while a profiler is active, and a recorded span
inside `trace.recording()`.  The body of an op on ``plain`` or ``cuda``
(the kernel's plain version, or the CUDA launch with its operands made
contiguous) runs inside `_body`: under
`tapped(tap)` that is ``tap(kernel, operands)``, through which the dry runs
(`launch/ocean_dryrun.py`, `launch/lm_dryrun.py`) count the kernel by its
formula (`roofline/kernels.py`) and none of the ops inside, so a step costs
the same on either backend.  On ``cuda`` K9 and K8 are called through their
`torch.library` custom ops (``repro_torch::flash_attention``,
``::flash_attention_stats``, ``::wkv6``); on fake tensors ``plain`` calls
them too, so a traced step runs only their fakes, which allocate the
outputs.
``LAUNCHES[(kernel, backend)]`` counts kernel calls by the name of the
kernel (`KERNEL[op]`): the CUDA wrappers count their own launches, and
`_dispatch` counts the ref and plain calls, so each call adds one to each
counter.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import cell_transpose, column_solve, dispatch, flash_attention
from . import horizontal_flux, matrix_free
from . import ref as _ref
from . import tridiag as _tridiag
from . import wkv6 as _wkv6
from .dispatch import LAUNCHES, Backend, reset_launches  # noqa: F401
from ..obs import metrics as _metrics
from ..obs import trace as _trace

# the kernel each op runs, by the name LAUNCHES counts it under
KERNEL = {
    "solve_r": "solve_r", "solve_r_cell": "solve_r",
    "solve_w": "solve_w", "solve_w_cell": "solve_w",
    "block_thomas": "block_thomas", "block_thomas_cell": "block_thomas",
    "lateral_flux": "lateral_flux", "tridiag": "tridiag",
    "soa_to_cell": "soa_to_cell", "cell_to_soa": "cell_to_soa",
    "wkv6": "wkv6", "attention": "flash_attention",
}


_TAPS: list = []


@contextlib.contextmanager
def tapped(tap):
    """Run the enclosed block with ``tap(kernel, operands)``, a context
    manager, around every ocean kernel body."""
    _TAPS.append(tap)
    try:
        yield
    finally:
        _TAPS.pop()


def _body(kernel: str, *operands):
    """The kernel body's context: the innermost tap's, else none."""
    return _TAPS[-1](kernel, operands) if _TAPS else contextlib.nullcontext()


# the weight a dry run's counter gives each op it sees (`counted`)
_WEIGHTS: list = [1]


@contextlib.contextmanager
def counted(weight: int):
    """Ops run inside count ``weight`` times in a dry run's trace: a loop
    whose body is traced once for its trip count, as the JAX package's HLO
    analysis counts a while loop (`models/mamba.py`), or 0 for work a
    trace makes that the program does not.  Outside a trace it changes
    nothing."""
    _WEIGHTS.append(_WEIGHTS[-1] * weight)
    try:
        yield
    finally:
        _WEIGHTS.pop()


def weight() -> int:
    """The weight `counted` gives the ops run now."""
    return _WEIGHTS[-1]


@contextlib.contextmanager
def _dispatch(op: str, bk: Backend):
    """Count the dispatch and open its span (`obs/trace.py`)."""
    _metrics.default().counter("kernel_dispatch", op=op, backend=bk.value).inc()
    if bk is not Backend.CUDA:
        LAUNCHES[(KERNEL[op], bk.value)] += 1
    with _trace.annotate(f"kops.{op}.{bk.value}"):
        yield


# ---------------------------------------------------------------------------
# SoA signatures (the stepper hot path)
# ---------------------------------------------------------------------------
def _components(F: torch.Tensor, bc):
    """(..., nl, 6, nt) -> (K, nl, 6, nt) and bc (..., 3, nt) -> (K, 3, nt)."""
    *lead, nl, six, nt = F.shape
    K = math.prod(lead)
    Fk = F.reshape(K, nl, six, nt).contiguous()
    if bc is not None:
        bc = bc.expand(*lead, 3, nt).reshape(K, 3, nt).contiguous()
    return Fk, bc


def solve_r(geom, F, r_surf, backend: dispatch.BackendLike = None):
    """Matrix-free D_vu solve: F (..., nl, 6, nt); r_surf (..., 3, nt)."""
    from ..core import vertical
    bk = dispatch.resolve(backend, F.device)
    with _dispatch("solve_r", bk):
        if bk is Backend.REF:
            return vertical.solve_r(geom, F, r_surf)
        Fk, bc = _components(F, r_surf)
        with _body("solve_r", Fk, geom.area, bc):
            if bk is Backend.PLAIN:
                out = matrix_free.solve_r_plain(Fk, geom.area, bc)
            else:
                out = matrix_free.solve_r(Fk, geom.area, bc)
        return out.reshape(F.shape)


def solve_w(geom, F, w_floor=None, backend: dispatch.BackendLike = None):
    """Matrix-free D_vd solve: F (..., nl, 6, nt); w_floor (..., 3, nt) or
    None (impermeable floor)."""
    from ..core import vertical
    bk = dispatch.resolve(backend, F.device)
    with _dispatch("solve_w", bk):
        if bk is Backend.REF:
            return vertical.solve_w(geom, F, w_floor)
        Fk, bc = _components(F, w_floor)
        with _body("solve_w", Fk, geom.area, bc):
            if bk is Backend.PLAIN:
                out = matrix_free.solve_w_plain(Fk, geom.area, bc)
            else:
                out = matrix_free.solve_w(Fk, geom.area, bc)
        return out.reshape(F.shape)


def block_thomas(blocks, rhs, backend: dispatch.BackendLike = None):
    """Block-tridiagonal column solve: blocks (nl, 6, 6, nt) each,
    rhs (k, nl, 6, nt)."""
    from ..core import vertical
    bk = dispatch.resolve(backend, rhs.device)
    with _dispatch("block_thomas", bk):
        if bk is Backend.REF:
            return vertical.block_thomas_solve(blocks, rhs)
        with _body("block_thomas", *blocks, rhs):
            if bk is Backend.PLAIN:
                return column_solve.block_thomas_plain(*blocks, rhs)
            lo, dg, up = (b.contiguous() for b in blocks)
            return column_solve.block_thomas(lo, dg, up, rhs.contiguous())


def lateral_flux_term(geom, f, fext, speed,
                      backend: dispatch.BackendLike = None):
    """Fused lateral advective flux term <<phi f_up speed Jl>>.

    f: (k, nl, 6, nt) nodal fields; fext: (k, nl, 3, 2, 2, nt) post-BC
    neighbour nodal values from dg3d.edge_ext_nodal6; speed: (nl, 2, 3, 2, nt)
    signed normal flux speed shared by the k fields.  Returns (k, nl, 6, nt).
    The ref backend runs the plain version, as it has no other form."""
    bk = dispatch.resolve(backend, f.device)
    with _dispatch("lateral_flux", bk), \
            _body("lateral_flux", f, fext, speed, geom.edge_len):
        if bk is not Backend.CUDA:
            return horizontal_flux.lateral_flux_plain(f, fext, speed,
                                                      geom.edge_len)
        return horizontal_flux.lateral_flux(f.contiguous(), fext.contiguous(),
                                            speed.contiguous(), geom.edge_len)


# ---------------------------------------------------------------------------
# cell-layout signatures (the JAX package's `ops.py:55-107`)
# ---------------------------------------------------------------------------
def tridiag(dl, d, du, b, backend: dispatch.BackendLike = None):
    """Scalar tridiagonal solve of (nl, C) systems; dl[0], du[nl-1] ignored."""
    bk = dispatch.resolve(backend, d.device)
    with _dispatch("tridiag", bk):
        if bk is Backend.REF:
            return _ref.tridiag(dl, d, du, b)
        with _body("tridiag", dl, d, du, b):
            if bk is Backend.PLAIN:
                return _tridiag.tridiag_plain(dl, d, du, b)
            return _tridiag.tridiag(*(t.contiguous() for t in (dl, d, du, b)))


def _sweep_cell(op, ref_fn, plain_fn, kernel_fn, F, area, bc, backend):
    """Shared dispatch of the matrix-free sweeps in cell layout: F (nl*6, C),
    area (1, C), bc (3, C); the kernels see (1, nl, 6, C) views."""
    bk = dispatch.resolve(backend, F.device)
    with _dispatch(op, bk):
        if bk is Backend.REF:
            return ref_fn(F, area, bc)
        rows, C = F.shape
        Fk = F.reshape(1, rows // 6, 6, C)
        a, bck = area.reshape(C), bc.reshape(1, 3, C)
        with _body(KERNEL[op], Fk, a, bck):
            if bk is Backend.PLAIN:
                out = plain_fn(Fk, a, bck)
            else:
                out = kernel_fn(Fk.contiguous(), a.contiguous(),
                                bck.contiguous())
        return out.reshape(rows, C)


def solve_r_cell(F, area, r_surf, backend: dispatch.BackendLike = None):
    """Matrix-free D_vu solve in cell layout: F (nl*6, C), area (1, C),
    r_surf (3, C)."""
    return _sweep_cell("solve_r_cell", _ref.solve_r_cell,
                       matrix_free.solve_r_plain, matrix_free.solve_r,
                       F, area, r_surf, backend)


def solve_w_cell(F, area, w_floor, backend: dispatch.BackendLike = None):
    """Matrix-free D_vd solve in cell layout: F (nl*6, C), area (1, C),
    w_floor (3, C)."""
    return _sweep_cell("solve_w_cell", _ref.solve_w_cell,
                       matrix_free.solve_w_plain, matrix_free.solve_w,
                       F, area, w_floor, backend)


def block_thomas_cell(lo, dg, up, b, backend: dispatch.BackendLike = None):
    """Block-tridiagonal solve: lo/dg/up (nl, 6, 6, C), b (nl, 6, k, C)."""
    bk = dispatch.resolve(backend, b.device)
    with _dispatch("block_thomas_cell", bk):
        if bk is Backend.REF:
            return _ref.block_thomas_cell(lo, dg, up, b)
        rhs = torch.movedim(b, 2, 0).contiguous()          # (k, nl, 6, C)
        with _body("block_thomas", lo, dg, up, rhs):
            if bk is Backend.PLAIN:
                x = column_solve.block_thomas_plain(lo, dg, up, rhs)
            else:
                x = column_solve.block_thomas(lo.contiguous(), dg.contiguous(),
                                              up.contiguous(), rhs)
        return torch.movedim(x, 0, 2)


def soa_to_cell(x, backend: dispatch.BackendLike = None):
    """(nl, 6, nt) -> (ceil(nt/128), nl*6, 128), zero-padding nt."""
    bk = dispatch.resolve(backend, x.device)
    with _dispatch("soa_to_cell", bk):
        if bk is Backend.REF:
            return _ref.soa_to_cell(x)
        with _body("soa_to_cell", x):
            if bk is Backend.PLAIN:
                return cell_transpose.soa_to_cell_plain(x)
            return cell_transpose.soa_to_cell(x.contiguous())


def cell_to_soa(x, nt, backend: dispatch.BackendLike = None):
    """(nc, nl*6, 128) -> (nl, 6, nt), slicing the padding off."""
    bk = dispatch.resolve(backend, x.device)
    with _dispatch("cell_to_soa", bk):
        if bk is Backend.REF:
            return _ref.cell_to_soa(x, nt)
        with _body("cell_to_soa", x, nt):
            if bk is Backend.PLAIN:
                return cell_transpose.cell_to_soa_plain(x, nt)
            return cell_transpose.cell_to_soa(x.contiguous(), nt)


# ---------------------------------------------------------------------------
# model kernels (the JAX package's `ops.py:219-240`)
# ---------------------------------------------------------------------------
def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (the dry run's): then even ``plain``
    calls the custom op, whose fake allocates the outputs and nothing
    more, so a traced step holds no (T, T) scores on either backend."""
    return isinstance(t, FakeTensor)


def wkv6(r, k, v, w, u, backend: dispatch.BackendLike = None):
    """RWKV6 recurrence: r, k, w (BH, T, K); v (BH, T, V); u (K,) or (H, K).

    With inputs that require grad, ``plain`` and ``cuda`` go through
    `models.rwkv.WKV6` (this op forward, the chunked form's gradient
    backward); ``ref`` is autograd through the reference scan."""
    bk = dispatch.resolve_model(backend, r.device)
    if bk is not Backend.REF and _needs_grad(r, k, v, w, u):
        from ..models.rwkv import WKV6
        return WKV6.apply(r, k, v, w, u, bk.value)
    with _dispatch("wkv6", bk):
        if bk is Backend.REF:
            return _ref.wkv6(r, k, v, w, u)
        with _body("wkv6", r, k, v, w, u):
            if bk is Backend.PLAIN and not is_fake(r):
                return _wkv6.wkv6_plain(r, k, v, w, u)
            return _wkv6.wkv6_op(*(t.contiguous() for t in (r, k, v, w, u)))


def attention(q, k, v, causal=True, window=None, softcap=None,
              backend: dispatch.BackendLike = None):
    """Attention: q (BH, Tq, d), k/v (BH, Tk, d).

    With inputs that require grad, ``plain`` and ``cuda`` go through
    `models.attention.FlashAttention` (`attention_with_stats` forward, the
    port of JAX's custom VJP backward); ``ref`` is autograd through the
    reference's chunked softmax."""
    bk = dispatch.resolve_model(backend, q.device)
    if bk is not Backend.REF and _needs_grad(q, k, v):
        from ..models.attention import FlashAttention
        return FlashAttention.apply(q, k, v, causal, window, softcap, bk.value)
    with _dispatch("attention", bk):
        if bk is Backend.REF:
            return _ref.chunked_attention(q, k, v, causal=causal,
                                          window=window, softcap=softcap)
        return _attention_body(q, k, v, causal, window, softcap, bk, False)


def attention_with_stats(q, k, v, causal=True, window=None, softcap=None,
                         backend: dispatch.BackendLike = None):
    """`attention` and its row statistics: (out, m, l), m and l float32
    (BH, Tq), on ``plain`` or ``cuda`` (``ref`` keeps none)."""
    bk = dispatch.resolve_model(backend, q.device)
    if bk is Backend.REF:
        raise ValueError("attention_with_stats: backend 'ref' keeps no row "
                         "statistics ('plain' or 'cuda')")
    with _dispatch("attention", bk):
        return _attention_body(q, k, v, causal, window, softcap, bk, True)


def _attention_body(q, k, v, causal, window, softcap, bk: Backend,
                    stats: bool):
    """K9's body on ``plain`` or ``cuda``: the plain version, or the custom
    op (the kernel; its fake on fake tensors)."""
    with _body("flash_attention", q, k, v, causal, window, softcap, stats):
        if bk is Backend.PLAIN and not is_fake(q):
            return flash_attention.flash_attention_plain(
                q, k, v, causal=causal, window=window, softcap=softcap,
                stats=stats)
        op = (flash_attention.attention_stats_op if stats
              else flash_attention.attention_op)
        return op(q.contiguous(), k.contiguous(), v.contiguous(), causal,
                  window, softcap)
