"""Flash attention of the LM forward on the (B, H, T, d) layout (the JAX
package's `models/attention.py`, its forward `flash_attention_xla`).

The heads merge with the batch into K9's (B*H, T, d) layout, contiguous,
and `ops.attention` computes the masked online softmax: causal, the
sliding window ``k > q - window`` and the soft-cap after the scale, with
the output in q's dtype.  JAX's custom VJP (its backward) belongs to
training and is not ported here; on the card the kernel is forward only
(`ops.attention` refuses inputs that require grad).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import dispatch, ops


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
