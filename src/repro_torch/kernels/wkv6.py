"""RWKV6 (Finch) WKV recurrence with data-dependent decay: CUDA kernel K8.

Per head, with a float32 state S in R^{K x V} that starts at zero:

    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
          = r_t^T S_{t-1} + (sum_i r_ti u_i k_ti) v_t
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T

Shapes: r, k, w (BH, T, K); v (BH, T, V); u (K,), shared by every head, or
(H, K), one row a head, head bh taking row bh % H (BH a multiple of H, as
JAX `models/rwkv.py::_wkv_with_state` repeats it); the result is (BH, T, V)
in v's dtype.

The kernel (`csrc/model_kernels.cu`: wkv6_kernel<T, K, R, C>) holds R rows
by C columns of S a thread, in registers (4 x 8 in float32, 8 x 4 in
bfloat16: TILES); a column's K rows are split over L = K / R lanes, whose
partial output sums are reduced with warp shuffles.
float32 computes the second, factored form: each lane adds (sum over its
rows of r u k) v_t to its partial sums.  bfloat16 keeps the TPU kernel's
rounding of u k v^T to bfloat16, element by element: where the bonus
dominates a row and cancels, the factored sum differs from it by more than
the bfloat16 tolerance.  A block holds `block_cols` columns of one head
and walks time in tiles of TILE steps that cp.async brings to shared memory
a tile ahead.  `launch_plan` picks all of that before the launch; the C
launcher builds only the dtype's tile and refuses any other plan.  K in
{16, 32, 64}, any V and any T (the TPU version needs T % 128 == 0), float32
and bfloat16.

`wkv6` launches the kernel and takes only CUDA tensors; `wkv6_plain` is the
plain PyTorch version, the Pallas body step by step, used on CPU tensors and
to check the kernel; `wkv6_partitioned` is the plain version in the
kernel's own order (per-lane partial sums, the shuffle tree, the bonus as
the kernel adds it), which holds the plan's partition on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import types

import torch

from . import cuda_lib
from .dispatch import LAUNCHES

HEAD_DIMS = (16, 32, 64)      # the K the kernel is built for
# the thread tile of each dtype: (rows, columns) of S a thread holds; the
# faster on an H100 in every call that timed both (PERF.md, K8)
TILES = {torch.float32: (4, 8), torch.bfloat16: (8, 4)}
TILE = 32                     # time steps a tile (kWkvTile)
STAGES = 2                    # tiles in shared memory (kWkvStages)
MAX_THREADS = 256             # the kernel's __launch_bounds__
MAX_WARPS = MAX_THREADS // 32
MAX_SMEM = 232_448            # shared memory a block can opt in to (H100)
MAX_GRID = 2 ** 31 - 1


def smem_bytes(K: int, block_cols: int, itemsize: int) -> int:
    """Shared bytes of a block (`wkv_smem_bytes` in the CUDA source): the
    tiles of both stages in the inputs' dtype."""
    return STAGES * TILE * (3 * K + block_cols) * itemsize


def alignment(*ptrs: int) -> int:
    """The largest power of two up to 16 that divides every address."""
    a = 16
    for p in ptrs:
        while p % a:
            a //= 2
    return a


def _access_bytes(V: int, itemsize: int, align: int) -> int:
    """The widest copy (16, 8, 4 bytes, or 2 for bfloat16 element by
    element) that every pointer's alignment and a v row's length allow."""
    for b in (16, 8, 4, 2):
        if b >= itemsize and b <= align and (V * itemsize) % b == 0:
            return b
    raise ValueError(f"wkv6: no access width for V={V}, itemsize {itemsize}, "
                     f"pointers aligned to {align} bytes")


def _plans(BH: int, K: int, V: int, dtype: torch.dtype, align: int) -> list:
    """Every launch of K8 for BH heads of K rows and V columns, widest block
    first: the dtype's thread tile, and each block width that is a whole
    number of warps, at most MAX_WARPS of them and MAX_SMEM shared bytes,
    and no wider than V needs."""
    if dtype not in cuda_lib.MODEL_DTYPES:
        raise TypeError(f"wkv6: {dtype} is not built (float32 or bfloat16)")
    if K not in HEAD_DIMS:
        raise ValueError(f"wkv6: K={K} is not built (K in {HEAD_DIMS})")
    if BH < 1 or V < 1:
        raise ValueError(f"wkv6: empty input (BH={BH}, V={V})")
    rows, cols = TILES[dtype]
    lanes = K // rows
    warp_cols = 32 // lanes * cols
    access = _access_bytes(V, dtype.itemsize, align)
    plans = []
    for nw in range(1, MAX_WARPS + 1):
        block_cols = nw * warp_cols
        smem = smem_bytes(K, block_cols, dtype.itemsize)
        if block_cols >= V + warp_cols or smem > MAX_SMEM:
            break
        grid = BH * -(-V // block_cols)
        if grid > MAX_GRID:
            raise ValueError(f"wkv6: {grid} blocks are more than a grid holds")
        plans.append(types.MappingProxyType(dict(
            rows=rows, cols=cols, lanes=lanes, warp_cols=warp_cols,
            block_cols=block_cols, threads=block_cols // cols * lanes,
            tile=TILE, stages=STAGES, smem=smem, bytes=access, grid=grid)))
    return plans[::-1]


@functools.lru_cache(maxsize=256)
def launch_plan(BH: int, K: int, V: int, dtype: torch.dtype,
                align: int = 16) -> types.MappingProxyType:
    """K8's launch for BH heads of K rows and V columns: the dtype's thread
    tile (rows x cols of S, lanes a column), the widest block (a whole head
    at rwkv6-3b, so r, k and w are copied once a head; wider ran faster on
    an H100, PERF.md, K8), threads, time tile, stages, shared bytes, access
    width (from V and ``align``, the pointers' common alignment) and grid.
    The sequence length does not enter it.  Read only (plans are cached)."""
    return _plans(BH, K, V, dtype, align)[0]


def alternatives(BH: int, K: int, V: int, dtype: torch.dtype,
                 align: int = 16) -> list:
    """Every plan the launcher takes for this shape: one a block width, the
    plan's own (the widest) first."""
    return _plans(BH, K, V, dtype, align)


def lane_rows(K: int, rows: int) -> list:
    """The rows of S lane g of a column group holds, for each g: 4 L q + 4 g
    + e for q < rows / 4, e < 4, in the order the lane sums them."""
    lanes = K // rows
    return [[4 * lanes * q + 4 * g + e for q in range(rows // 4)
             for e in range(4)] for g in range(lanes)]


def thread_columns(plan, tid: int) -> list:
    """The columns, within its block, that thread ``tid`` holds."""
    lanes, cols = plan["lanes"], plan["cols"]
    lane, warp = tid % 32, tid // 32
    c0 = (warp * (32 // lanes) + lane // lanes) * cols
    return list(range(c0, c0 + cols))


def _bonus_rows(u: torch.Tensor, BH: int) -> torch.Tensor:
    """u (K,) or (H, K) -> (BH, K): head bh takes row bh % H."""
    if u.dim() == 1:
        return u[None].expand(BH, -1)
    return u.repeat(BH // u.shape[0], 1)


def _check_u(u: torch.Tensor, BH: int, K: int) -> None:
    ok = u.dim() == 1 and u.shape[0] == K or (
        u.dim() == 2 and u.shape[1] == K and 1 <= u.shape[0]
        and BH % u.shape[0] == 0)
    if not ok:
        raise ValueError(f"wkv6: u must be (K,) = ({K},) or (H, {K}) with H "
                         f"dividing BH = {BH}, got {tuple(u.shape)}")


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The Pallas kernel's body (`repro/kernels/wkv6.py:40-61`), all heads at
    once: S in float32, kv = k_t v_t^T and u kv in the inputs' dtype, each
    output row cast to v's dtype.  u is (K,) or (H, K)."""
    BH, T, K = r.shape
    _check_u(u, BH, K)
    S = torch.zeros((BH, K, v.shape[-1]), dtype=torch.float32, device=r.device)
    out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    uu = _bonus_rows(u, BH)[:, :, None]
    for t in range(T):
        kv = k[:, t, :, None] * v[:, t, None, :]
        out[:, t] = (r[:, t, :, None] * (S + uu * kv)).sum(dim=1).to(v.dtype)
        S = w[:, t, :, None] * S + kv
    return out


def wkv6_partitioned(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, plan) -> torch.Tensor:
    """The plain version in the kernel's order under ``plan``: each lane's
    partial output over its rows (`lane_rows`), the partials summed over
    the lanes' bits from the lowest, as the shuffles pair them; kv in the
    inputs' dtype, S and every sum in float32.  float32 factors the bonus:
    each lane adds (sum over its rows of r u k) v to its partial; bfloat16
    keeps the TPU kernel's rounding of u kv element by element."""
    BH, T, K = r.shape
    _check_u(u, BH, K)
    V = v.shape[-1]
    lanes = plan["lanes"]
    rows = lane_rows(K, plan["rows"])
    exact = v.dtype == torch.bfloat16
    uu = _bonus_rows(u, BH)
    S = torch.zeros((BH, K, V), dtype=torch.float32, device=r.device)
    out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    for t in range(T):
        rt, kt, wt = r[:, t].float(), k[:, t].float(), w[:, t].float()
        vt = v[:, t].float()
        kv = k[:, t, :, None] * v[:, t, None, :]
        ukv = (uu[:, :, None] * kv).float()
        part = []
        for g in range(lanes):
            if exact:
                o = torch.zeros_like(vt)
                for i in rows[g]:
                    o = o + rt[:, i, None] * (S[:, i] + ukv[:, i])
            else:
                a = torch.zeros_like(rt[:, 0])
                o = torch.zeros_like(vt)
                for i in rows[g]:
                    a = a + rt[:, i] * (uu[:, i].float() * kt[:, i])
                    o = o + rt[:, i, None] * S[:, i]
                o = o + a[:, None] * vt
            part.append(o)
        off = 1
        while off < lanes:
            part = [part[g] + part[g ^ off] for g in range(lanes)]
            off *= 2
        out[:, t] = part[0].to(v.dtype)
        S = wt[:, :, None] * S + kv.float()
    return out


def blocks_per_sm(plan, K: int, dtype: torch.dtype) -> int:
    """Blocks of ``plan`` that one SM of the current card holds at once, by
    the CUDA occupancy calculator."""
    blocks = ctypes.c_int64()
    cuda_lib.call("wkv6_occupancy", dtype, K, plan["rows"], plan["cols"],
                  plan["threads"], plan["smem"], ctypes.byref(blocks))
    return blocks.value


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, plan=None) -> torch.Tensor:
    """K8 on the card: the RWKV6 recurrence of (BH, T, K) r, k, w and
    (BH, T, V) v with the bonus u, (K,) or (H, K).  ``plan`` overrides
    `launch_plan`'s choice (a plan of `alternatives`, for timing them); the
    launcher refuses a plan it did not build."""
    if r.dim() != 3 or v.dim() != 3:
        raise ValueError(f"wkv6: expected r (BH, T, K) and v (BH, T, V), got "
                         f"{tuple(r.shape)} and {tuple(v.shape)}")
    BH, T, K = r.shape
    V = v.shape[-1]
    dtypes = cuda_lib.MODEL_DTYPES
    for name, t in (("r", r), ("k", k), ("w", w)):
        cuda_lib.check(name, t, (BH, T, K), v, dtypes)
    cuda_lib.check("v", v, (BH, T, V), v, dtypes)
    _check_u(u, BH, K)
    cuda_lib.check("u", u, tuple(u.shape), v, dtypes)
    if K not in HEAD_DIMS:
        raise ValueError(f"wkv6: K={K} is not built (K in {HEAD_DIMS})")
    if BH < 1 or T < 1 or V < 1:
        raise ValueError(f"wkv6: empty input (BH={BH}, T={T}, V={V})")
    if plan is None:
        align = alignment(*(t.data_ptr() for t in (r, k, v, w)))
        plan = launch_plan(BH, K, V, v.dtype, align)
    H = u.shape[0] if u.dim() == 2 else 1
    out = torch.empty_like(v)
    cuda_lib.launch("wkv6", v.dtype, v.device, r.data_ptr(), k.data_ptr(),
                    v.data_ptr(), w.data_ptr(), u.data_ptr(), out.data_ptr(),
                    BH, T, K, V, H,
                    *(plan[key] for key in LAUNCH_KEYS))
    LAUNCHES[("wkv6", "cuda")] += 1
    return out


# the plan's entries the C launcher takes, in its order
LAUNCH_KEYS = ("rows", "cols", "block_cols", "threads", "tile", "stages",
               "smem", "bytes", "grid")


# ---------------------------------------------------------------------------
# the custom op: K8 as an operator that fake tensors can trace
# ---------------------------------------------------------------------------
def _wkv6_op(r, k, v, w, u):
    """K8 on a CUDA tensor; on a CPU tensor its plain version."""
    if v.device.type == "cuda":
        return wkv6(r, k, v, w, u)
    return wkv6_plain(r, k, v, w, u)


# `torch.ops.repro_torch.wkv6`: what `kernels/ops.py` calls on the card; under
# fake tensors (the dry run) only its fake runs, which allocates the output
wkv6_op = torch.library.custom_op(
    "repro_torch::wkv6", _wkv6_op, mutates_args=(),
    schema="(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u) -> Tensor")


@wkv6_op.register_fake
def _wkv6_fake(r, k, v, w, u):
    return torch.empty_like(v, memory_format=torch.contiguous_format)
