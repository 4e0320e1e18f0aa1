"""Kernel-backend dispatch for the ocean hot path.

Three backends, chosen per call from the backend name and the device of
the tensors:

  * ``Backend.REF``   — the plain column solvers of `core/vertical.py` and
                        the qp-level lateral scatter (`dg3d.lat_scatter`);
                        the equivalence oracles.
  * ``Backend.PLAIN`` — the kernel path (same wrappers, same k=4 stacking,
                        same call sites) with each kernel body replaced by
                        its plain PyTorch version.
  * ``Backend.CUDA``  — the hand-written CUDA kernels of `csrc/`.

``auto`` (or None) resolves to CUDA on a CUDA tensor and to PLAIN on a CPU
tensor.  CUDA on a CPU tensor raises: no request for the card ever runs on
the CPU, and a CUDA tensor never reaches a plain version through ``auto``.
The model kernels (`ops.wkv6`, `ops.attention`) resolve through
`resolve_model`, whose ``auto`` is REF on a CPU tensor, as the JAX
package's model ops default to their jnp forms off the TPU.

``LAUNCHES`` counts calls per (op, backend).  The CUDA wrappers add one
where they launch their kernel; `ops.py` adds one for each plain and ref
call.  `reset_launches()` sets every count to 0.
"""
from __future__ import annotations

import collections
import enum
from typing import Optional, Union

import torch


class Backend(str, enum.Enum):
    REF = "ref"
    PLAIN = "plain"
    CUDA = "cuda"


BackendLike = Optional[Union[str, Backend]]

LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def resolve(backend: BackendLike, device: torch.device) -> Backend:
    """Normalise a backend spec for tensors on ``device``."""
    device = torch.device(device)
    if backend is None or backend == "auto":
        return Backend.CUDA if device.type == "cuda" else Backend.PLAIN
    bk = Backend(backend)
    if bk is Backend.CUDA and device.type != "cuda":
        raise ValueError(f"backend 'cuda' needs CUDA tensors, got {device}")
    return bk


def resolve_model(backend: BackendLike, device: torch.device) -> Backend:
    """`resolve` for the model kernels: ``auto`` (or None) is CUDA on a CUDA
    tensor and REF on a CPU tensor."""
    if (backend is None or backend == "auto") and torch.device(device).type != "cuda":
        return Backend.REF
    return resolve(backend, device)


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another.  Raises when the card is asked for (or implied) and none
    is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return dev
