"""Error-feedback int8 gradient compression for the data-parallel
all-reduce (the JAX package's `optim/compression.py`).

Per leaf, over the ranks of a `torch.distributed` group: the error-fed
gradient gf = g + e, one shared scale from the all-reduce (MAX) of
max |gf|, the int8 payload round(gf / scale) clipped to +-127, and the
all-reduce (SUM) of that payload as int32; the mean is the sum times the
scale over the ranks, and the new error is gf minus what was sent.  The
quantisation error stays in the error-feedback state (SGD-EF / 1-bit-Adam
style), which restores full convergence asymptotically.  Rounding is half
to even, as `jnp.round`.

With no process group (one process) the collectives are identities: the
result is the one rank's quantised gradient, as JAX's on one device.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from .. import tree


def init_error_state(grads_like: Any) -> Any:
    return tree.map_leaves(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like)


def compressed_grad_psum(grads: Any, err: Any, group=None,
                         n_devices: Optional[int] = None) -> Tuple[Any, Any]:
    """All-reduce-mean ``grads`` over ``group`` (the default group; none when
    torch.distributed is not initialised) with int8 + error feedback.
    ``n_devices`` defaults to the group's size.  Returns (mean_grads,
    new_error_state)."""
    distributed = dist.is_available() and dist.is_initialized()
    if n_devices is None:
        n_devices = dist.get_world_size(group) if distributed else 1

    def one(g, e):
        gf = g.float() + e
        # shared scale across the ranks so the int payloads are summable
        amax = torch.max(torch.abs(gf))
        if distributed:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(amax / 127.0, min=1e-30)
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        new_e = gf - q.float() * scale                   # error feedback
        summed = q.to(torch.int32)
        if distributed:
            dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        mean = summed.float() * scale / n_devices
        return mean.to(g.dtype), new_e

    out = [one(g, e) for g, e in zip(tree.leaves(grads), tree.leaves(err))]
    return (tree.unflatten(grads, [o[0] for o in out]),
            tree.unflatten(grads, [o[1] for o in out]))
