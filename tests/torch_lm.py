"""Shared set-up of the LM tests of the PyTorch port: a reduced architecture
built in both frameworks, JAX's parameters carried into the port by
`convert.lm_params_from_numpy`, and seeded numpy batches.

Both models run in float32 on the CPU; the port's forward on ``backend``
(``ref`` or ``plain``; `auto` is ``ref`` on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ALL_ARCHS as J_ARCHS
from repro.configs import get_arch as j_get_arch
from repro.configs import reduce_arch as j_reduce_arch
from repro.models.model import Model as JModel
from repro_torch import convert
from repro_torch.configs import get_arch, reduce_arch
from repro_torch.models.model import Model

ARCHS = sorted(J_ARCHS)
DECODERS = [n for n in ARCHS if not J_ARCHS[n].encoder_only]
# logits within TOL of max |logit| (float32, other summation orders)
TOL = 1e-4


def pair(name: str, seed: int = 0, backend="ref"):
    """(JAX model, JAX params, port model, port params) of the reduced
    ``name`` in float32, the port's parameters carried across from JAX's."""
    jm = JModel(j_reduce_arch(j_get_arch(name)), dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = Model(reduce_arch(get_arch(name)), dtype=torch.float32, device="cpu",
               backend=backend)
    tp = convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def batch(arch, B: int, T: int, seed: int, labels: bool = True):
    """Seeded numpy inputs of one batch: tokens (and labels), the vlm
    patch embeddings or the audio frame embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, arch.vocab, (B, T)).astype(np.int32)}
    if arch.frontend == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (B, arch.n_patches, arch.d_model)).astype(np.float32)
    if arch.frontend == "audio":
        out["frame_embeds"] = rng.standard_normal(
            (B, T, arch.d_model)).astype(np.float32)
    if labels:
        out["labels"] = rng.integers(0, arch.vocab, (B, T)).astype(np.int32)
    return out


def to_jax(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b: dict) -> dict:
    return {k: torch.from_numpy(v) if v.dtype != np.int32
            else torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


def rel_err(out, ref) -> float:
    """max |out - ref| over max |ref|."""
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, np.float32)
    ref = ref.detach().float().numpy() if isinstance(ref, torch.Tensor) \
        else np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))
