"""Architecture configuration schema and the shape table of the LM pool
(the JAX package's `configs/base.py`, field for field)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..models.mamba import MambaCfg
from ..models.moe import MoeCfg
from ..models.rwkv import RwkvCfg


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    rope_theta: float = 1e4
    window: Optional[int] = None     # sliding window (gemma2 local layers)
    alt_local_global: bool = False   # gemma2: even layers local, odd global
    softcap_attn: Optional[float] = None
    softcap_logits: Optional[float] = None
    norm: str = "rms"                # rms | nonparam (olmo)
    act: str = "swiglu"              # swiglu | gelu
    causal: bool = True
    encoder_only: bool = False
    frontend: Optional[str] = None   # vlm | audio (stub embeddings)
    n_patches: int = 256             # vlm stub prefix length
    moe: Optional[MoeCfg] = None
    moe_period: int = 1              # apply MoE every k-th layer (jamba: 2)
    attn_period: int = 0             # hybrid: 1 attention layer per k (jamba 8)
    mamba: Optional[MambaCfg] = None
    rwkv: Optional[RwkvCfg] = None
    tie_embeddings: bool = False
    remat: bool = True               # read by training only; inference ignores it

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))


# ---- shape table -------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# long_500k only for sub-quadratic families; encoder-only has no decode
LONG_FAMILIES = ("ssm", "hybrid")


def applicable_shapes(arch: ArchConfig) -> Tuple[str, ...]:
    out = ["train_4k", "prefill_32k"]
    if not arch.encoder_only:
        out.append("decode_32k")
        if arch.family in LONG_FAMILIES:
            out.append("long_500k")
    return tuple(out)
