"""RWKV6 (Finch) block (the JAX package's `models/rwkv.py`): time-mix with
data-dependent decay, and channel-mix.

Prefill (no carried state) runs the WKV recurrence through `ops.wkv6` (K8
on the card), which starts from S = 0 and returns no final state, the
prefill contract (JAX discards S_T there).  Decode carries (token shift,
WKV state) and steps `_wkv_with_state` in plain torch on every backend, as
JAX does outside any Pallas kernel.

The dtype chain is JAX's: the projections in the activations' dtype, the
decay w = exp(-exp(decay + dd)) in float32, w rounded to the activations'
dtype on prefill, the recurrence in float32, `out * (1 + ln_x)` in float32
and the cast before `w_o`.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import Draw


@dataclasses.dataclass(frozen=True)
class RwkvCfg:
    head_dim: int = 64

    def n_heads(self, d_model):
        return d_model // self.head_dim


def rwkv_params(draw: Draw, d_model, d_ff, cfg: RwkvCfg, dtype=torch.bfloat16):
    sc = 1.0 / (d_model ** 0.5)
    lora = max(d_model // 16, 32)
    f32 = torch.float32
    return {
        "mix_r": draw.full((d_model,), 0.5, dtype),
        "mix_k": draw.full((d_model,), 0.5, dtype),
        "mix_v": draw.full((d_model,), 0.5, dtype),
        "mix_w": draw.full((d_model,), 0.5, dtype),
        "w_r": draw.normal((d_model, d_model), sc, dtype),
        "w_k": draw.normal((d_model, d_model), sc, dtype),
        "w_v": draw.normal((d_model, d_model), sc, dtype),
        "w_o": draw.normal((d_model, d_model), sc, dtype),
        # data-dependent decay: w_t = exp(-exp(decay + lora(x)))
        "decay": draw.full((d_model,), -1.0, f32),
        "w_dd1": draw.normal((d_model, lora), sc, dtype),
        "w_dd2": draw.normal((lora, d_model), 0.1, dtype),
        "bonus": draw.normal((d_model,), 0.1, f32),
        "ln_x": draw.full((d_model,), 0.0, dtype),
        # channel mix
        "cmix_k": draw.full((d_model,), 0.5, dtype),
        "w_ck": draw.normal((d_model, d_ff), sc, dtype),
        "w_cv": draw.normal((d_ff, d_model), 1.0 / (d_ff ** 0.5), dtype),
        "w_cr": draw.normal((d_model, d_model), sc, dtype),
    }


def _token_shift(x, last=None):
    """Shift by one token: (B, T, D) -> previous token's activation."""
    B, T, D = x.shape
    prev = x.new_zeros((B, 1, D)) if last is None else last
    return torch.cat([prev, x[:, :-1]], dim=1)


def time_mix(p, x, cfg: RwkvCfg, shift_state=None, wkv_state=None,
             backend=None):
    """x (B, T, D) -> (out, (new_shift, new_wkv)); states enable decode.

    With ``wkv_state`` None (prefill) the recurrence goes through
    `ops.wkv6` on ``backend`` in float32 and new_wkv is None."""
    B, T, D = x.shape
    H = cfg.n_heads(D)
    K = cfg.head_dim
    xs = _token_shift(x, shift_state)

    def mix(m):
        return x * m + xs * (1 - m)
    r = mix(p["mix_r"]) @ p["w_r"]
    k = mix(p["mix_k"]) @ p["w_k"]
    v = mix(p["mix_v"]) @ p["w_v"]
    xw = mix(p["mix_w"]).float()
    dd = (xw @ p["w_dd1"].float()) @ p["w_dd2"].float()
    w = torch.exp(-torch.exp(p["decay"][None, None] + dd))   # (B, T, D) in (0,1)

    def heads(z):
        """(B, T, D) -> (B*H, T, K) float32: head bh is (b, h), bh = b H + h."""
        return z.reshape(B, T, H, K).transpose(1, 2).reshape(B * H, T, K).float()
    u = p["bonus"].reshape(H, K)

    if wkv_state is None:
        # K8 takes head bh to u's row bh % H, JAX's (B, H) -> B*H order
        out = ops.wkv6(heads(r), heads(k), heads(v), heads(w.to(x.dtype)), u,
                       backend=backend)
        new_wkv = None
    else:
        out, new_wkv = _wkv_with_state(heads(r), heads(k), heads(v),
                                       heads(w), u, wkv_state)
    out = out.reshape(B, H, T, K).transpose(1, 2).reshape(B, T, D)
    # group-norm-ish scale (float32) then output proj
    out = out * (1.0 + p["ln_x"])
    out = out.to(x.dtype) @ p["w_o"]
    return out, (x[:, -1:], new_wkv)


def _wkv_with_state(r, k, v, w, u, S0):
    """WKV with an explicit initial state (decode path), float32: r, k, v, w
    (BH, T, K); u (H, K), head bh taking row bh % H; S0 (BH, K, K).
    Returns (out (BH, T, K), S_T)."""
    BH = r.shape[0]
    uh = u.repeat(BH // u.shape[0], 1) if u.dim() == 2 else u
    S = S0
    out = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, None] * v[:, t, None, :]
        out.append((r[:, t, :, None] * (S + uh[:, :, None] * kv)).sum(dim=1))
        S = w[:, t, :, None] * S + kv
    return torch.stack(out, dim=1), S


def channel_mix(p, x, shift_state=None):
    xs = _token_shift(x, shift_state)
    xk = x * p["cmix_k"] + xs * (1 - p["cmix_k"])
    h = torch.square(F.relu(xk @ p["w_ck"]))
    r = torch.sigmoid(x @ p["w_cr"])
    return r * (h @ p["w_cv"]), x[:, -1:]


def init_rwkv_state(batch, d_model, cfg: RwkvCfg, dtype=torch.bfloat16,
                    device="cpu"):
    H = cfg.n_heads(d_model)
    return {
        "tm_shift": torch.zeros((batch, 1, d_model), dtype=dtype, device=device),
        "cm_shift": torch.zeros((batch, 1, d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((batch * H, cfg.head_dim, cfg.head_dim),
                           dtype=torch.float32, device=device),
    }
