"""Config registry of the LM pool: one ArchConfig per architecture (the JAX
package's `configs/`), with `get_arch` and the reduced same-family configs
of the CPU tests."""
import dataclasses

from .archs import ALL_ARCHS
from .base import SHAPES, ArchConfig, ShapeSpec, applicable_shapes

__all__ = ["ALL_ARCHS", "SHAPES", "ArchConfig", "ShapeSpec",
           "applicable_shapes", "get_arch", "reduce_arch"]


def get_arch(name: str) -> ArchConfig:
    if name not in ALL_ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ALL_ARCHS)}")
    return ALL_ARCHS[name]


def reduce_arch(arch: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests (small layers/width,
    few experts, tiny vocab), preserving the super-block program shape."""
    from ..models.model import block_program
    from ..models.moe import MoeCfg
    prog_len = len(block_program(arch))
    hd = 16
    n_heads = max(arch.n_heads and 4, 4)
    n_kv = 2 if arch.n_kv < arch.n_heads else n_heads
    changes = dict(
        n_layers=prog_len, d_model=n_heads * hd, n_heads=n_heads, n_kv=n_kv,
        d_ff=96, vocab=128, head_dim=hd, n_patches=4, window=(
            16 if arch.window else None), remat=False)
    if arch.moe is not None:
        changes["moe"] = MoeCfg(n_experts=4, top_k=2, d_ff=32,
                                n_shared=min(arch.moe.n_shared, 1))
    return dataclasses.replace(arch, **changes)
