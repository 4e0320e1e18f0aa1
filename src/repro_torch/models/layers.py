"""Shared transformer layers (the JAX package's `models/layers.py`): norms,
RoPE, GQA attention (prefill through `ops.attention`, cached decode in plain
torch, gemma2's sliding window and logit soft-cap, olmo's non-parametric
LN), MLPs, and the seeded draws every parameter tree is made from.

Conventions: activations (B, T, D); parameters are nested dicts of tensors;
attention weights are head-major, (D, H, hd) and (H, hd, D), as in JAX.
The dtype promotions follow JAX's: a bfloat16 tensor times a float32 one is
float32, and each function casts back where JAX does.

On a mesh the activations and parameters are DTensors (`models/sharding`):
a layout hook is a ``(DeviceMesh, placements)`` pair, applied by `pin`
with `redistribute` where JAX applies `with_sharding_constraint`, and only
to a DTensor.  Attention's core runs under `local_map` on each rank's own
heads and batch rows (`head_placements`), so K9 sees plain tensors, the
rank's shard; plain tensors made inside a layer (RoPE's tables) join a
DTensor computation replicated (`replicated_like`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..launch.mesh import is_dtensor
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
    # TP head padding: q, k and v padded with zero heads to this many
    # before the core (a head count the model axis divides), the output
    # sliced back; the padded heads' outputs are discarded
    pad_heads_to: Optional[int] = None


def attn_params(draw: Draw, d_model, cfg: AttnCfg, dtype=torch.bfloat16):
    hd = cfg.head_dim
    sc = 1.0 / (d_model ** 0.5)
    return {
        "wq": draw.normal((d_model, cfg.n_heads, hd), sc, dtype),
        "wk": draw.normal((d_model, cfg.n_kv, hd), sc, dtype),
        "wv": draw.normal((d_model, cfg.n_kv, hd), sc, dtype),
        "wo": draw.normal((cfg.n_heads, hd, d_model), sc, dtype),
    }


# --- DTensor layouts ------------------------------------------------------------------
def pin(x, sharding):
    """`jax.lax.with_sharding_constraint`: ``x`` redistributed to
    ``sharding`` = (DeviceMesh, placements) when ``x`` is a DTensor and
    ``sharding`` is set; else ``x`` itself."""
    if sharding is None or not is_dtensor(x):
        return x
    mesh, placements = sharding
    return x.redistribute(mesh, tuple(placements))


def replicated_like(t: torch.Tensor, x):
    """``t`` (the same on every rank) as a replicated DTensor on ``x``'s
    mesh when ``x`` is a DTensor; else ``t``."""
    if not is_dtensor(x):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _rows_of(like) -> tuple:
    """Placements of a DTensor's batch rows and the partial-sum gradient
    of a replicated input used against them: Partial on each mesh dim that
    splits ``like``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    pl = tuple(like.placements)
    return pl, tuple(Partial() if isinstance(p, Shard) else Replicate()
                     for p in pl)


def embed_lookup(table, tokens):
    """``table[tokens]``.  On DTensors each rank looks its own tokens up in
    the whole table under `local_map` (DTensor's index rule fails in the
    backward), the table's gradient a partial sum over the mesh dims that
    split the tokens."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    tokens = tokens if is_dtensor(tokens) else replicated_like(tokens, table)
    pl, partial = _rows_of(tokens)
    whole = (Replicate(),) * table.device_mesh.ndim
    return local_map(lambda t, i: t[i], out_placements=(pl,),
                     in_placements=(whole, pl), in_grad_placements=(partial, pl),
                     redistribute_inputs=True)(table, tokens)


def token_nll(lf, labels):
    """Cross entropy of each token: logsumexp(lf) - lf[label], float32 lf
    (..., V).  On DTensors each rank takes its own rows with the whole
    vocab under `local_map` (DTensor's gather rule fails in the
    backward)."""
    def nll(lf_, labels_):
        lse = torch.logsumexp(lf_, dim=-1)
        return lse - torch.gather(lf_, -1, labels_[..., None].long())[..., 0]
    if not is_dtensor(lf):
        return nll(lf, labels)
    from torch.distributed.tensor.experimental import local_map
    labels = labels if is_dtensor(labels) else replicated_like(labels, lf)
    pl, _ = _rows_of(labels)
    return local_map(nll, out_placements=(pl,), in_placements=(pl, pl),
                     redistribute_inputs=True)(lf, labels)


def gather_fsdp(p):
    """FSDP's gather before use: in a (nested dict) tree of parameters, each
    DTensor's shards over the mesh dims other than "model" gathered, its
    tensor-parallel shards kept.  The layers then see Megatron's layout,
    one sharded dim a weight, for which DTensor has a rule in every op (a
    flatten of two sharded dims, as an einsum over an FSDP-sharded `wo`
    makes, has none).  Under remat the gather runs again in the backward,
    as FSDP's does; a tree of plain tensors comes back as it is."""
    if isinstance(p, dict):
        return {k: gather_fsdp(v) for k, v in p.items()}
    if not is_dtensor(p):
        return p
    from torch.distributed.tensor import Replicate
    names = p.device_mesh.mesh_dim_names
    pl = tuple(q if names[i] == "model" else Replicate()
               for i, q in enumerate(p.placements))
    return p if pl == tuple(p.placements) else p.redistribute(p.device_mesh, pl)


def head_placements(mesh, batch: int, heads: int) -> tuple:
    """Placements of a (B, H, ...) tensor on ``mesh``: the heads over
    "model" when it divides them, the batch over the data-parallel axes
    ("pod", "data") when they divide it (else over the first alone, as
    `sharding.batch_pspecs` falls back), else replicated."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    dp = [a for a in names if a in ("pod", "data")]
    prod = 1
    for a in dp:
        prod *= sizes[a]
    if dp and batch % prod:
        dp = dp[:1] if batch % sizes[dp[0]] == 0 else []
    out = []
    for a in names:
        if a == "model" and heads % sizes[a] == 0:
            out.append(Shard(1))
        elif a in dp:
            out.append(Shard(0))
        else:
            out.append(Replicate())
    return tuple(out)


def core_placements(x, sharding) -> tuple:
    """Placements a kernel core (attention, WKV) runs at on the (B, H, T, ...)
    DTensor ``x``: ``sharding``'s when it is set, else `head_placements`.
    Each rank's core sees whole sequences, so only the batch and the heads
    may be split."""
    from torch.distributed.tensor import Replicate, Shard
    if sharding is None:
        return head_placements(x.device_mesh, x.shape[0], x.shape[1])
    pl = tuple(sharding[1])
    if any(p not in (Shard(0), Shard(1), Replicate()) for p in pl):
        raise ValueError(f"a kernel core splits only the batch and the "
                         f"heads of (B, H, T, ...), not {pl}")
    return pl


def _repeat_kv(k, n_heads):
    """(B, T, Kv, hd) -> (B, T, H, hd) by group replication (a new tensor)."""
    return torch.repeat_interleave(k, n_heads // k.shape[2], dim=2)


def attention(p, x, cfg: AttnCfg, positions: torch.Tensor, backend=None,
              head_sharding=None):
    """Full (train/prefill) attention. x (B, T, D) -> (B, T, D).

    q, k and v go to `attention.flash_attention` on the (B, H, T, hd)
    layout after RoPE and the KV repeat (and the zero heads of
    ``cfg.pad_heads_to``), and from there to `ops.attention` (K9 on the
    card) as (B*H, T, hd) contiguous tensors.  On DTensors they are first
    pinned to ``head_sharding`` (JAX's), and the core runs under
    `local_map` at ``head_sharding``'s placements, or `head_placements`'
    when it is None: each rank merges and attends its own heads and rows."""
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", x, p["wk"])
    v = torch.einsum("btd,dhk->bthk", x, p["wv"])
    cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta, positions)
    cos, sin = replicated_like(cos, x), replicated_like(sin, x)
    q = apply_rope(q, cos, sin)
    k = _repeat_kv(apply_rope(k, cos, sin), cfg.n_heads)
    v = _repeat_kv(v, cfg.n_heads)
    qh, kh, vh = (z.transpose(1, 2) for z in (q, k, v))     # (B, H, T, hd)
    Hp = cfg.pad_heads_to
    padded = Hp is not None and Hp > cfg.n_heads
    if padded:
        qh, kh, vh = (F.pad(z, (0, 0, 0, 0, 0, Hp - cfg.n_heads))
                      for z in (qh, kh, vh))
    qh, kh, vh = (pin(z, head_sharding) for z in (qh, kh, vh))

    def core(q_, k_, v_):
        return flash_attention(q_, k_, v_, cfg.causal, cfg.window,
                               cfg.softcap, backend=backend)
    if is_dtensor(qh):
        from torch.distributed.tensor.experimental import local_map
        pl = core_placements(qh, head_sharding)
        core = local_map(core, out_placements=(pl,), in_placements=(pl, pl, pl),
                         redistribute_inputs=True)
    out = core(qh, kh, vh)
    if padded:
        out = out[:, :cfg.n_heads]
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

