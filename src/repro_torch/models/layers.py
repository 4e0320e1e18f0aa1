"""Shared transformer layers (the JAX package's `models/layers.py`): norms,
RoPE, GQA attention (prefill through `ops.attention`, cached decode in plain
torch, gemma2's sliding window and logit soft-cap, olmo's non-parametric
LN), MLPs, and the seeded draws every parameter tree is made from.

Conventions: activations (B, T, D); parameters are nested dicts of tensors;
attention weights are head-major, (D, H, hd) and (H, hd, D), as in JAX.
The dtype promotions follow JAX's: a bfloat16 tensor times a float32 one is
float32, and each function casts back where JAX does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .attention import flash_attention



# --- seeded parameter draws --------------------------------------------------------
class Draw:
    """Parameter draws from one explicit generator on one device, every
    tensor with the leading axes ``lead`` (a stack of super-blocks).  On the
    ``meta`` device it makes shapes and dtypes only."""

    def __init__(self, generator: Optional[torch.Generator], device,
                 lead: Sequence[int] = ()):
        self.generator = generator
        self.device = torch.device(device)
        self.lead = tuple(lead)

    def stacked(self, n: int) -> "Draw":
        return Draw(self.generator, self.device, self.lead + (n,))

    def normal(self, shape, scale: float, dtype) -> torch.Tensor:
        """N(0, 1) * scale, drawn in float32, cast to ``dtype``."""
        shape = self.lead + tuple(shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.device)
        x = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        return (x * scale).to(dtype)

    def full(self, shape, value: float, dtype) -> torch.Tensor:
        return torch.full(self.lead + tuple(shape), value, dtype=dtype,
                          device=self.device)

    def const(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` repeated over the leading axes."""
        x = x.to(self.device)
        return x.expand(self.lead + tuple(x.shape)).clone()


# --- norms ---------------------------------------------------------------------
def rms_norm(x, w, eps=1e-6):
    # x (not its float32 copy) times the float32 rsqrt: bfloat16 x promotes
    v = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(v + eps) * (1.0 + w)).to(x.dtype)


def nonparam_layer_norm(x, eps=1e-5):
    """OLMo: LayerNorm without any learnable parameters."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def norm(x, w, kind: str):
    if kind == "nonparam":
        return nonparam_layer_norm(x)
    return rms_norm(x, w)


# --- RoPE ----------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """positions (T,) -> (T, head_dim/2) cos/sin tables, float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (B, T, H, hd); cos/sin (T, hd/2)."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# --- attention --------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AttnCfg:
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 1e4
    window: Optional[int] = None      # sliding-window size (gemma2 local)
    softcap: Optional[float] = None   # logit soft-capping (gemma2)
    causal: bool = True               # False for encoder-only (hubert)
    # JAX pads the heads for tensor-parallel sharding; one card has none,
    # so the field is kept for the schema and refused when set
    pad_heads_to: Optional[int] = None

    def __post_init__(self):
        if self.pad_heads_to is not None:
            raise ValueError("AttnCfg.pad_heads_to pads heads for sharding "
                             "over devices, which the port does not do")


def attn_params(draw: Draw, d_model, cfg: AttnCfg, dtype=torch.bfloat16):
    hd = cfg.head_dim
    sc = 1.0 / (d_model ** 0.5)
    return {
        "wq": draw.normal((d_model, cfg.n_heads, hd), sc, dtype),
        "wk": draw.normal((d_model, cfg.n_kv, hd), sc, dtype),
        "wv": draw.normal((d_model, cfg.n_kv, hd), sc, dtype),
        "wo": draw.normal((cfg.n_heads, hd, d_model), sc, dtype),
    }


def _repeat_kv(k, n_heads):
    """(B, T, Kv, hd) -> (B, T, H, hd) by group replication (a new tensor)."""
    return torch.repeat_interleave(k, n_heads // k.shape[2], dim=2)


def attention(p, x, cfg: AttnCfg, positions: torch.Tensor, backend=None):
    """Full (train/prefill) attention. x (B, T, D) -> (B, T, D).

    q, k and v go to `attention.flash_attention` on the (B, H, T, hd)
    layout after RoPE and the KV repeat, and from there to `ops.attention`
    (K9 on the card) as (B*H, T, hd) contiguous tensors."""
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", x, p["wk"])
    v = torch.einsum("btd,dhk->bthk", x, p["wv"])
    cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta, positions)
    q = apply_rope(q, cos, sin)
    k = _repeat_kv(apply_rope(k, cos, sin), cfg.n_heads)
    v = _repeat_kv(v, cfg.n_heads)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), cfg.causal, cfg.window,
                          cfg.softcap, backend=backend)
    return torch.einsum("bthk,hkd->btd", out.transpose(1, 2), p["wo"])


def decode_attention(p, x, cfg: AttnCfg, kv_cache, pos: int):
    """Single-token decode against a KV cache, in plain torch.

    x: (B, 1, D); kv_cache: dict(k, v: (B, Tmax, Kv, hd)); pos: the token's
    index.  Writes the token's k and v into the cache in place and returns
    (out (B, 1, D), the cache).  A masked softmax over the whole cache
    (``ids <= pos`` and the window), grouped heads without repeating KV."""
    B, _, D = x.shape
    pos = int(pos)
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k_new = torch.einsum("btd,dhk->bthk", x, p["wk"])
    v_new = torch.einsum("btd,dhk->bthk", x, p["wv"])
    cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta,
                          torch.tensor([pos], device=x.device))
    q = apply_rope(q, cos, sin)
    k_new = apply_rope(k_new, cos, sin)
    kc, vc = kv_cache["k"], kv_cache["v"]
    kc[:, pos] = k_new[:, 0].to(kc.dtype)
    vc[:, pos] = v_new[:, 0].to(vc.dtype)
    ids = torch.arange(kc.shape[1], device=x.device)
    valid = ids <= pos
    if cfg.window is not None:
        valid = valid & (ids > pos - cfg.window)
    rep = cfg.n_heads // cfg.n_kv
    qg = q[:, 0].reshape(B, cfg.n_kv, rep, cfg.head_dim).float()
    s = torch.einsum("bgrk,btgk->bgrt", qg, kc.float()) / (cfg.head_dim ** 0.5)
    if cfg.softcap is not None:
        s = cfg.softcap * torch.tanh(s / cfg.softcap)
    s = torch.where(valid[None, None, None, :], s, -1e30)
    pattn = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrt,btgk->bgrk", pattn, vc.float())
    out = out.reshape(B, cfg.n_heads, cfg.head_dim)
    out = torch.einsum("bhk,hkd->bd", out.to(x.dtype), p["wo"])
    return out[:, None, :], kv_cache


# --- MLPs ------------------------------------------------------------------------
def mlp_params(draw: Draw, d_model, d_ff, act: str, dtype=torch.bfloat16):
    sc_in = 1.0 / (d_model ** 0.5)
    sc_out = 1.0 / (d_ff ** 0.5)
    p = {"w_out": draw.normal((d_ff, d_model), sc_out, dtype)}
    if act == "swiglu":
        p["w_gate"] = draw.normal((d_model, d_ff), sc_in, dtype)
    p["w_in"] = draw.normal((d_model, d_ff), sc_in, dtype)
    return p


def gelu(x):
    """`jax.nn.gelu`'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(p, x, act: str):
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_in"])
    else:
        h = gelu(x @ p["w_in"])
    return h @ p["w_out"]

