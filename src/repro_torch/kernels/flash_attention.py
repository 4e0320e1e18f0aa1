"""Forward flash attention with optional causal mask, sliding window and
tanh logit soft-cap: CUDA kernel K9.

q (BH, Tq, d), k and v (BH, Tk, d) -> (BH, Tq, d) in q's dtype.  Scores are
float32: s = (q * d^-1/2) k^T, soft-capped as softcap * tanh(s / softcap),
then masked to -1e30 where a key is above the diagonal (causal: k <= q,
top-left aligned) or outside the window (k > q - window).  The softmax runs
online over key blocks, with the running max m, the normaliser l (floored
at 1e-30 at the end) and the output accumulator in float32.

The kernel (`csrc/flash_attention.cu`) runs one block per (bh, query tile)
over key tiles in shared memory, and skips the key tiles that lie wholly
above the causal diagonal or below the window.  In bfloat16
(`flash_bf16_kernel`) both products run on the tensor cores (`wgmma`), the
Q, K and V tiles arrive by TMA into swizzled shared memory, K and V in a
ring of stages; in float32 (`flash_f32_kernel`) they run on the FP32 pipes,
register-blocked, with K (double-buffered) and V loaded by `cp.async`.  The tile
sizes, column chunks, swizzle, stages and shared-memory bytes of each are
the launch plan (`launch_plan`), computed here and checked by the C
launcher against the kernel it compiled.  It takes any Tq and Tk (the TPU
version needs multiples of 128), head dims in `HEAD_DIMS`, float32 and
bfloat16, and tensors whose data is 16-byte aligned (TMA and `cp.async`
read 16-byte units).

A query row with no valid key at all (with a window, the rows q >= Tk +
window - 1, causal or not) keeps m at the sentinel, so every key gets p = 1
and the row is the mean of v over all Tk keys: in the Pallas kernel, the
plain version, `ref` and the CUDA kernel alike.

With ``stats=True`` both return (out, m, l): the row statistics of the
backward (`models/attention.py`), float32 (BH, Tq), the final running max
and normaliser, as JAX's custom VJP saves them (m, l and not lse = m +
log l: a row with no valid key keeps m = -1e30 and l = Tk, and the
backward gives its keys p = 1 / l).  The kernel writes them only when
asked; without them it stores what it always stored.

`flash_attention` launches the kernel and takes only CUDA tensors;
`flash_attention_plain` is the plain PyTorch version, the Pallas kernel's
body over 128-key blocks, used on CPU tensors and to check the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib
from .dispatch import LAUNCHES

NEG_INF = -1e30
BLOCK_K = 128                            # the Pallas kernel's key block
HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # the d the kernel is built for
MAX_BH = 65535                           # the launch grid's y extent
MAX_SMEM = 232_448                       # shared memory a block can use (H100)
ALIGN = 16                               # bytes: TMA and cp.async units


def launch_plan(d: int, dtype: torch.dtype) -> dict:
    """The kernel's tiling for head dim ``d`` and ``dtype``: query and key
    tile rows, the column chunk each shared-memory row is cut into and its
    swizzle span in bytes (bf16: TMA boxes and wgmma descriptors; float32
    has no chunks: 0), stages (of K and V; float32: of K), threads and
    shared-memory bytes.

    bfloat16: 128 query rows (two warpgroups of 64) and a producer
    warpgroup; 128-key tiles (64 at d = 256, where the 128-float O
    accumulator leaves no registers for 128 scores); 3 K/V stages (2 at
    d = 256, for shared memory); chunks of 64 columns with 128-byte swizzle
    where 64 divides d, else 32 (64 B) at d = 32 and 16 (32 B) at d = 16 and
    80; 1 KB of slack to align the tiles to the swizzle pattern, and the
    mbarriers.  float32: 256 threads, key tiles of 64 at d = 128 (else
    32), 128 query rows (64 at d = 256), K in 2 stages and V in one, rows
    padded by 4 floats (P by 8)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not built "
                         f"(d in {HEAD_DIMS})")
    if dtype == torch.bfloat16:
        block_q, block_k, threads = 128, (64 if d == 256 else 128), 384
        stages = 3 if d <= 128 else 2
        chunk = 64 if d % 64 == 0 else (32 if d == 32 else 16)
        smem = 1024 + 2 * d * (block_q + 2 * stages * block_k) \
            + 8 * (1 + 2 * stages)
        swizzle = 2 * chunk
    elif dtype == torch.float32:
        block_q, threads = (64 if d == 256 else 128), 256
        block_k = 64 if d == 128 else 32
        stages, chunk = 2, 0
        swizzle = 0
        smem = 4 * (block_q * (d + 4) + stages * block_k * (d + 4)
                    + block_k * d + block_q * (block_k + 8))
    else:
        raise TypeError(f"flash_attention: {dtype} is not built "
                        "(float32 or bfloat16)")
    return dict(block_q=block_q, block_k=block_k, chunk=chunk,
                swizzle=swizzle, stages=stages, threads=threads,
                smem_bytes=smem)


def grid(plan: dict, BH: int, Tq: int) -> tuple:
    """The launch grid: (query tiles, BH)."""
    return (-(-Tq // plan["block_q"]), BH)


def tile_order(plan: dict, Tq: int) -> list:
    """First query row of the tile that block x of a head takes, for x =
    0, 1, ...: the kernels' q0 = (gridDim.x - 1 - x) * block_q, the last
    tile first, since under a causal mask its rows see the most keys
    (blocks start in order of x)."""
    ntq = grid(plan, 1, Tq)[0]
    return [(ntq - 1 - x) * plan["block_q"] for x in range(ntq)]


def _check_options(window, softcap) -> None:
    if window is not None and window < 1:
        raise ValueError(f"attention: window={window} masks every key (>= 1)")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"attention: softcap={softcap} must be > 0")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None, stats: bool = False):
    """The Pallas kernel's body (`repro/kernels/flash_attention.py:24-65`)
    over key blocks of 128, all query rows at once: q is scaled in its own
    dtype, p is cast to v's dtype before the PV product, both products sum
    in float32.  A ragged last key block is cut short, which for every row
    with a valid key gives what masked padding would."""
    _check_options(window, softcap)
    BH, Tq, d = q.shape
    Tk = k.shape[1]
    dev = q.device
    qf = (q * (1.0 / (d ** 0.5))).float()
    q_ids = torch.arange(Tq, device=dev)[:, None]
    m = torch.full((BH, Tq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((BH, Tq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((BH, Tq, d), dtype=torch.float32, device=dev)
    for k0 in range(0, Tk, BLOCK_K):
        kb, vb = k[:, k0:k0 + BLOCK_K], v[:, k0:k0 + BLOCK_K]
        s = torch.matmul(qf, kb.float().transpose(1, 2))
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        k_ids = k0 + torch.arange(kb.shape[1], device=dev)[None, :]
        mask = torch.ones(s.shape[1:], dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (k_ids <= q_ids)
        if window is not None:
            mask = mask & (k_ids > q_ids - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.matmul(p.to(v.dtype).float(), vb.float())
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return (out, m[..., 0], l[..., 0]) if stats else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, stats: bool = False):
    """K9 on the card: q (BH, Tq, d), k/v (BH, Tk, d) -> (BH, Tq, d), and
    with ``stats`` the row statistics m and l, float32 (BH, Tq)."""
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"flash_attention: expected q (BH, Tq, d) and k/v "
                         f"(BH, Tk, d), got {tuple(q.shape)}, {tuple(k.shape)}")
    BH, Tq, d = q.shape
    Tk = k.shape[1]
    dtypes = cuda_lib.MODEL_DTYPES
    cuda_lib.check("q", q, (BH, Tq, d), q, dtypes)
    cuda_lib.check("k", k, (BH, Tk, d), q, dtypes)
    cuda_lib.check("v", v, (BH, Tk, d), q, dtypes)
    plan = launch_plan(d, q.dtype)
    if not (1 <= BH <= MAX_BH and 1 <= Tq < 2 ** 31 and 1 <= Tk < 2 ** 31):
        raise ValueError(f"flash_attention: unsupported shape (BH={BH}, "
                         f"Tq={Tq}, Tk={Tk}; 1 <= BH <= {MAX_BH})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % ALIGN:
            raise ValueError(f"flash_attention: {name}'s data is not "
                             f"{ALIGN}-byte aligned")
    _check_options(window, softcap)
    out = torch.empty_like(q)
    m = l = None
    if stats:
        m, l = (torch.empty((BH, Tq), dtype=torch.float32, device=q.device)
                for _ in range(2))
    cuda_lib.launch("flash_attention", q.dtype, q.device, q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if m is None else m.data_ptr(),
                    None if l is None else l.data_ptr(), BH, Tq, Tk, d,
                    int(bool(causal)), 0 if window is None else int(window),
                    1.0 / (d ** 0.5), 0.0 if softcap is None else float(softcap),
                    plan["block_q"], plan["block_k"], plan["chunk"],
                    plan["stages"], plan["threads"], plan["smem_bytes"],
                    grid(plan, BH, Tq)[0])
    LAUNCHES[("flash_attention", "cuda")] += 1
    return (out, m, l) if stats else out


# ---------------------------------------------------------------------------
# the custom ops: K9 as an operator that fake tensors can trace
# ---------------------------------------------------------------------------
def _attention_op(q, k, v, causal, window, softcap):
    """K9 on a CUDA tensor; on a CPU tensor its plain version."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal, window, softcap)
    return flash_attention_plain(q, k, v, causal, window, softcap)


def _attention_stats_op(q, k, v, causal, window, softcap):
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal, window, softcap, stats=True)
    return flash_attention_plain(q, k, v, causal, window, softcap, stats=True)


_ARGS = "Tensor q, Tensor k, Tensor v, bool causal, int? window, float? softcap"
# `torch.ops.repro_torch.flash_attention` and `...flash_attention_stats`:
# what `kernels/ops.py` calls on the card, and under fake tensors (the dry
# run) only their fakes run, which allocate the outputs and nothing else
attention_op = torch.library.custom_op(
    "repro_torch::flash_attention", _attention_op, mutates_args=(),
    schema=f"({_ARGS}) -> Tensor")
attention_stats_op = torch.library.custom_op(
    "repro_torch::flash_attention_stats", _attention_stats_op, mutates_args=(),
    schema=f"({_ARGS}) -> (Tensor, Tensor, Tensor)")


@attention_op.register_fake
def _attention_fake(q, k, v, causal, window, softcap):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@attention_stats_op.register_fake
def _attention_stats_fake(q, k, v, causal, window, softcap):
    BH, Tq, _ = q.shape
    m, l = (q.new_empty((BH, Tq), dtype=torch.float32) for _ in range(2))
    return _attention_fake(q, k, v, causal, window, softcap), m, l
