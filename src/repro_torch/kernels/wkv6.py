"""RWKV6 (Finch) WKV recurrence with data-dependent decay: CUDA kernel K8.

Per head, with a float32 state S in R^{K x V} that starts at zero:

    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T

Shapes: r, k, w (BH, T, K); v (BH, T, V); u (K,), shared by every head;
the result is (BH, T, V) in v's dtype.  The kernel (`csrc/model_kernels.cu`:
wkv6_kernel) runs one block per head and 64 value columns, one thread per
column holding S[:, v] in registers, and stages tiles of time steps of r, k,
w and v in shared memory.  It takes K in {16, 32, 64}, any V and any T (the
TPU version needs T % 128 == 0), in float32 and bfloat16.

`wkv6` launches the kernel and takes only CUDA tensors; `wkv6_plain` is the
plain PyTorch version, the Pallas body step by step, used on CPU tensors and
to check the kernel.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .dispatch import LAUNCHES

HEAD_DIMS = (16, 32, 64)      # the K the kernel is built for


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The Pallas kernel's body (`repro/kernels/wkv6.py:40-61`), all heads at
    once: S in float32, kv = k_t v_t^T in the inputs' dtype, each output row
    cast to v's dtype."""
    BH, T, K = r.shape
    S = torch.zeros((BH, K, v.shape[-1]), dtype=torch.float32, device=r.device)
    out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    uu = u[None, :, None]
    for t in range(T):
        kv = k[:, t, :, None] * v[:, t, None, :]
        out[:, t] = (r[:, t, :, None] * (S + uu * kv)).sum(dim=1).to(v.dtype)
        S = w[:, t, :, None] * S + kv
    return out


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor) -> torch.Tensor:
    """K8 on the card: the RWKV6 recurrence of (BH, T, K) r, k, w and
    (BH, T, V) v with the bonus u (K,)."""
    if r.dim() != 3 or v.dim() != 3:
        raise ValueError(f"wkv6: expected r (BH, T, K) and v (BH, T, V), got "
                         f"{tuple(r.shape)} and {tuple(v.shape)}")
    BH, T, K = r.shape
    V = v.shape[-1]
    dtypes = cuda_lib.MODEL_DTYPES
    for name, t in (("r", r), ("k", k), ("w", w)):
        cuda_lib.check(name, t, (BH, T, K), v, dtypes)
    cuda_lib.check("v", v, (BH, T, V), v, dtypes)
    cuda_lib.check("u", u, (K,), v, dtypes)
    if K not in HEAD_DIMS:
        raise ValueError(f"wkv6: K={K} is not built (K in {HEAD_DIMS})")
    if BH < 1 or T < 1 or V < 1:
        raise ValueError(f"wkv6: empty input (BH={BH}, T={T}, V={V})")
    out = torch.empty_like(v)
    cuda_lib.launch("wkv6", v.dtype, v.device, r.data_ptr(), k.data_ptr(),
                    v.data_ptr(), w.data_ptr(), u.data_ptr(), out.data_ptr(),
                    BH, T, K, V)
    LAUNCHES[("wkv6", "cuda")] += 1
    return out
