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
heads and batch rows (`core_placements`), so K9 sees plain tensors, the
rank's shard; plain tensors made inside a layer (RoPE's tables) join a
DTensor computation replicated (`replicated_like`).  The layouts that
GSPMD would give JAX's program are written out rather than left to
DTensor's strategies, which differ between torch versions: every
weight product at Megatron's layout (`tp_einsum`), the residual add at
the stream's layout (`add_residual`), the vocab-parallel lookup and loss
(`embed_lookup`, `token_nll`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..launch.mesh import is_dtensor
from ..obs.trace import annotate
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


# --- a chunked loop in a dry run's trace ----------------------------------------
def traced_chunks(body, n: int, chunk: int, state, *seqs_and_const):
    """A chunked scan on fake tensors (a dry run's trace,
    `launch/lm_dryrun.py`), where a dispatch a step and layer would cost
    too much: ``body(state, *chunk's slices of seqs, const) -> (state,
    out)`` traced on the first of the n chunks and counted n times
    (`ops.counted`), its output repeated over the n chunks, counting
    nothing.  Under grad the backward recomputes the chunk and takes its
    gradient, counted n times, as each chunk's checkpoint does, and adds
    each input's gradient n - 1 times, as autograd sums the chunks'.
    Returns out for all n chunks (along dim 1)."""
    return _Repeated.apply(_TracedChunks.apply(body, n, chunk, state,
                                               *seqs_and_const), n)


class _TracedChunks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, body, n, chunk, state, *seqs_and_const):
        ctx.body, ctx.n, ctx.chunk = body, n, chunk
        ctx.save_for_backward(state, *seqs_and_const)
        *seqs, const = seqs_and_const
        with ops.counted(n):
            return body(state, *(z[:, :chunk] for z in seqs), const)[1]

    @staticmethod
    def backward(ctx, gout):
        with ops.counted(ctx.n), torch.enable_grad():
            xs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            state, *seqs, const = xs
            _, out = ctx.body(state, *(z[:, :ctx.chunk] for z in seqs), const)
            grads = torch.autograd.grad(out, xs, gout, allow_unused=True)
        with ops.counted(ctx.n - 1):
            for g in grads[1:]:
                if g is not None:
                    g.add(g)
        return (None, None, None, *grads)


class _Repeated(torch.autograd.Function):
    """y (B, c, ...) repeated n times along dim 1, counting nothing either
    way."""

    @staticmethod
    def forward(ctx, y, n):
        ctx.n = n
        with ops.counted(0):
            return y.repeat(1, n, *([1] * (y.dim() - 2)))

    @staticmethod
    def backward(ctx, g):
        with ops.counted(0):
            B, T, *rest = g.shape
            return g.reshape(B, ctx.n, T // ctx.n, *rest).sum(dim=1), None


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


def all_reduce(t, op: str, mesh, dims):
    """``t`` all-reduced (``op`` "sum" or "max") over each mesh dim of
    ``dims`` in turn, outside autograd."""
    import torch.distributed._functional_collectives as funcol
    for d in dims:
        t = funcol.all_reduce(t, op, (mesh, d))
        t = t.wait() if hasattr(t, "wait") else t
    return t


class AllReduceSum(torch.autograd.Function):
    """The sum over the mesh dims ``dims`` of each rank's partial ``t``,
    used by every rank for its own channels: the backward sums the ranks'
    gradients the same way."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return all_reduce(t, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), "sum", ctx.mesh, ctx.dims), None, None


def _split_by(x, dim: int) -> list:
    """The mesh dims on which the DTensor ``x`` is `Shard(dim)`."""
    from torch.distributed.tensor import Shard
    return [d for d, q in enumerate(x.placements) if q == Shard(dim)]


def tp_einsum(eq: str, x, w):
    """``torch.einsum(eq, x, w)`` of activations x and a weight w, each dim
    a letter of ``eq``.  On DTensors under `local_map` at Megatron's
    layout, whatever DTensor's own strategy would pick (torch 2.13's
    gathers a column-parallel weight to multiply a `Partial` x, and
    computes every output column on every rank).  On each mesh dim:
      * x's rows (a dim of x and of the output only) stay where x has
        them, the weight whole there (its gradient a partial sum);
      * a weight split on an output dim (column-parallel) takes x whole
        and splits the output there (x's gradient a partial sum);
      * a weight split on a contracted dim (row-parallel) takes x split
        the same way and gives a `Partial` sum;
      * else both are whole (a `Partial` x is reduced)."""
    if not is_dtensor(x):
        return torch.einsum(eq, x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    ins, out = eq.split("->")
    xs, ws = ins.split(",")
    whole = (Replicate(),) * 5
    pls = []                     # (x, w, out, x's grad, w's grad) a mesh dim
    for q, wq in zip(x.placements, w.placements):
        lx = xs[q.dim] if isinstance(q, Shard) else None
        lw = ws[wq.dim] if isinstance(wq, Shard) else None
        if lx and lx in out and lx not in ws:
            pls.append((q, Replicate(), Shard(out.index(lx)), q, Partial()))
        elif lw and lw in out:
            pls.append((Replicate(), wq, Shard(out.index(lw)), Partial(), wq))
        elif lw and lw in xs:
            s = Shard(xs.index(lw))
            pls.append((s, wq, Partial(), s, wq))
        else:
            pls.append(whole)
    x_pl, w_pl, o_pl, x_grad, w_grad = zip(*pls)
    return local_map(lambda a, b: torch.einsum(eq, a, b),
                     out_placements=(o_pl,), in_placements=(x_pl, w_pl),
                     in_grad_placements=(x_grad, w_grad),
                     redistribute_inputs=True)(x, w)


def add_residual(x, y):
    """x + y, a sub-layer's output y added to the residual stream x.  On
    DTensors the sum takes the stream's layout (x's, a `Partial` one
    reduced), as GSPMD gives the add its operand's sharding: a row-parallel
    (`Partial`) output is all-reduced, or reduce-scattered onto a
    sequence-split stream, once (DTensor keeps such a sum partial and then
    reduces the next norm's float32 intermediates)."""
    if not (is_dtensor(x) and is_dtensor(y)):
        return x + y
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    pl = tuple(Replicate() if q.is_partial() else q for q in x.placements)
    return x.redistribute(mesh, pl) + y.redistribute(mesh, pl)


def embed_lookup(table, tokens):
    """``table[tokens]``.  On DTensors under `local_map` (DTensor's index
    rule fails in the backward).  Over the mesh dims that split the
    table's vocab and not the tokens (JAX's `embed` spec, ``P(tp,
    None)``), each rank looks its tokens up in its own vocab shard, a
    token outside it giving zero: the output is a `Partial` sum over those
    dims, which the next op reduces, and the table's gradient stays on the
    shard's rows.  Each rank looks up its own tokens; the table is
    gathered over every other mesh dim, its gradient a partial sum over
    the dims that split the tokens."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    tokens = tokens if is_dtensor(tokens) else replicated_like(tokens, table)
    pl, partial = _rows_of(tokens)
    vocab = [d for d in _split_by(table, 0) if pl[d] == Replicate()]
    t_pl = tuple(Shard(0) if d in vocab else Replicate() for d in range(len(pl)))
    out = tuple(Partial() if d in vocab else q for d, q in enumerate(pl))
    grad = tuple(Shard(0) if d in vocab else q for d, q in enumerate(partial))
    v0 = shard_offset(table.shape[0], table.device_mesh, t_pl, 0)

    def look(t, i):
        if not vocab:
            return t[i]
        i = i - v0
        inside = (i >= 0) & (i < t.shape[0])
        return torch.where(inside[..., None], t[i.clamp(0, t.shape[0] - 1)],
                           t.new_zeros(()))
    with annotate("layers.embed_lookup"):
        return local_map(look, out_placements=(out,), in_placements=(t_pl, pl),
                         in_grad_placements=(grad, pl),
                         redistribute_inputs=True)(table, tokens)


def _nll(lf, labels):
    lse = torch.logsumexp(lf, dim=-1)
    return lse - torch.gather(lf, -1, labels[..., None].long())[..., 0]


class _VocabNll(torch.autograd.Function):
    """Cross entropy of each row of a vocab shard lf (..., V_local),
    float32, whose first column is vocab id ``v0``, against global labels:
    the shard's max, sum of exp and gold logit (a range test, as JAX's
    one-hot over the sharded V) all-reduced over the mesh dims ``dims``
    that split V.  The backward, softmax minus the one-hot on the shard,
    is local; the max is a constant for it."""

    @staticmethod
    def forward(ctx, lf, labels, v0, mesh, dims):
        top = all_reduce(lf.amax(dim=-1), "max", mesh, dims)
        total = all_reduce(torch.exp(lf - top[..., None]).sum(dim=-1), "sum",
                           mesh, dims)
        i = labels.long() - v0
        inside = (i >= 0) & (i < lf.shape[-1])
        i = i.clamp(0, lf.shape[-1] - 1)
        gold = torch.gather(lf, -1, i[..., None])[..., 0]
        gold = all_reduce(torch.where(inside, gold, gold.new_zeros(())), "sum",
                          mesh, dims)
        lse = top + torch.log(total)
        ctx.save_for_backward(lf, lse, i, inside)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        lf, lse, i, inside = ctx.saved_tensors
        grad = torch.exp(lf - lse[..., None])
        grad.scatter_add_(-1, i[..., None], -inside[..., None].to(grad.dtype))
        return grad * g[..., None], None, None, None, None


def token_nll(lf, labels):
    """Cross entropy of each token: logsumexp(lf) - lf[label], float32 lf
    (..., V).  On DTensors under `local_map` (DTensor's gather rule fails
    in the backward) at the logits' own rows: where V is split (JAX's
    `logits_sharding`), vocab-parallel (`_VocabNll`: each rank's shard
    statistics all-reduced, no logit moved); else each rank takes its own
    rows with the whole vocab."""
    if not is_dtensor(lf):
        return _nll(lf, labels)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    labels = labels if is_dtensor(labels) else replicated_like(labels, lf)
    last = lf.dim() - 1
    vocab = _split_by(lf, last)
    if not vocab:
        pl, _ = _rows_of(labels)
        with annotate("layers.token_nll"):
            return local_map(_nll, out_placements=(pl,), in_placements=(pl, pl),
                             redistribute_inputs=True)(lf, labels)
    mesh = lf.device_mesh
    rows = tuple(q if isinstance(q, Shard) and q.dim < last else Replicate()
                 for q in lf.placements)
    lf_pl = tuple(Shard(last) if d in vocab else q for d, q in enumerate(rows))
    v0 = shard_offset(lf.shape[last], mesh, lf_pl, last)
    nll = lambda lf_, labels_: _VocabNll.apply(lf_, labels_, v0, mesh, vocab)
    with annotate("layers.token_nll"):
        return local_map(nll, out_placements=(rows,),
                         in_placements=(lf_pl, rows),
                         in_grad_placements=(lf_pl, rows),
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


def core_placements(x, sharding) -> tuple:
    """Placements a kernel core (attention, WKV) runs at on the (B, H, T, ...)
    DTensor ``x``: ``sharding``'s when it is set, else the batch where
    ``x`` already has it (`Shard(0)` on each mesh dim that splits it, as
    GSPMD keeps an operand's layout) and the heads over "model" when
    "model" does not carry the batch and divides them; every other mesh dim
    replicated.  Each rank's core sees whole sequences, so only the batch
    and the heads may be split."""
    from torch.distributed.tensor import Replicate, Shard
    if sharding is None:
        mesh = x.device_mesh
        return tuple(
            Shard(0) if p == Shard(0) else
            Shard(1) if name == "model" and x.shape[1] % size == 0 else
            Replicate()
            for p, name, size in zip(x.placements, mesh.mesh_dim_names,
                                     mesh.shape))
    pl = tuple(sharding[1])
    if any(p not in (Shard(0), Shard(1), Replicate()) for p in pl):
        raise ValueError(f"a kernel core splits only the batch and the "
                         f"heads of (B, H, T, ...), not {pl}")
    return pl


def _repeat_kv(k, n_heads):
    """(B, T, Kv, hd) -> (B, T, H, hd) by group replication (a new tensor)."""
    return torch.repeat_interleave(k, n_heads // k.shape[2], dim=2)


def _pad_heads(z, n: int):
    """(B, H, T, d) -> (B, H + n, T, d), the new heads zero.  On a DTensor
    (whose heads are whole: a head count that the model axis does not
    divide is not split) each rank pads its own under `local_map`."""
    pad = lambda t: F.pad(t, (0, 0, 0, 0, 0, n))
    if not is_dtensor(z):
        return pad(z)
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(z.placements)
    if Shard(1) in pl:
        raise ValueError(f"padding split heads ({pl})")
    return local_map(pad, out_placements=(pl,), in_placements=(pl,),
                     redistribute_inputs=True)(z)


def attention(p, x, cfg: AttnCfg, positions: torch.Tensor, backend=None,
              head_sharding=None):
    """Full (train/prefill) attention. x (B, T, D) -> (B, T, D).

    q, k and v go to `attention.flash_attention` on the (B, H, T, hd)
    layout after RoPE and the KV repeat (and the zero heads of
    ``cfg.pad_heads_to``), and from there to `ops.attention` (K9 on the
    card) as (B*H, T, hd) contiguous tensors.  On DTensors they are first
    pinned to ``head_sharding`` (JAX's), and the core runs under
    `local_map` at ``head_sharding``'s placements, or `core_placements`'
    when it is None: each rank merges and attends its own heads and rows."""
    q, k, v = (tp_einsum("btd,dhk->bthk", x, p[w]) for w in ("wq", "wk", "wv"))
    cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta, positions)
    cos, sin = replicated_like(cos, x), replicated_like(sin, x)
    q = apply_rope(q, cos, sin)
    k = _repeat_kv(apply_rope(k, cos, sin), cfg.n_heads)
    v = _repeat_kv(v, cfg.n_heads)
    qh, kh, vh = (z.transpose(1, 2) for z in (q, k, v))     # (B, H, T, hd)
    Hp = cfg.pad_heads_to
    padded = Hp is not None and Hp > cfg.n_heads
    if padded:
        qh, kh, vh = (_pad_heads(z, Hp - cfg.n_heads) for z in (qh, kh, vh))
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
    return tp_einsum("bthk,hkd->btd", out.transpose(1, 2), p["wo"])


def decode_attention(p, x, cfg: AttnCfg, kv_cache, pos: int):
    """Single-token decode against a KV cache, in plain torch.

    x: (B, 1, D); kv_cache: dict(k, v: (B, Tmax, Kv, hd)); pos: the token's
    index.  Writes the token's k and v into the cache in place and returns
    (out (B, 1, D), the cache).  A masked softmax over the whole cache
    (``ids <= pos`` and the window), grouped heads without repeating KV.
    On a DTensor cache, `_decode_attention_sharded`."""
    B, _, D = x.shape
    pos = int(pos)
    q, k_new, v_new = (tp_einsum("btd,dhk->bthk", x, p[w])
                       for w in ("wq", "wk", "wv"))
    cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta,
                          torch.tensor([pos], device=x.device))
    cos, sin = replicated_like(cos, x), replicated_like(sin, x)
    q = apply_rope(q, cos, sin)
    k_new = apply_rope(k_new, cos, sin)
    kc, vc = kv_cache["k"], kv_cache["v"]
    if is_dtensor(kc):
        out = _decode_attention_sharded(q, k_new, v_new, kc, vc, cfg, pos)
    else:
        kc[:, pos] = k_new[:, 0].to(kc.dtype)
        vc[:, pos] = v_new[:, 0].to(vc.dtype)
        ids = torch.arange(kc.shape[1], device=x.device)
        m, l, acc = _decode_partial(q[:, 0], kc, vc, ids, cfg, pos)
        out = acc / l
    out = out.reshape(B, cfg.n_heads, cfg.head_dim)
    out = tp_einsum("bhk,hkd->bd", out.to(x.dtype), p["wo"])
    return out[:, None, :], kv_cache


def _decode_partial(q, kc, vc, ids, cfg: AttnCfg, pos: int):
    """The softmax of q (B, H, hd) over the keys ``ids`` of the cache
    kc, vc (B, t, Kv, hd), unnormalised: (row max m, normaliser l, output
    sum acc), float32, m and l (B, Kv, rep, 1), acc (B, Kv, rep, hd); the
    keys past ``pos`` and outside the window masked."""
    B = q.shape[0]
    valid = ids <= pos
    if cfg.window is not None:
        valid = valid & (ids > pos - cfg.window)
    rep = cfg.n_heads // cfg.n_kv
    qg = q.reshape(B, cfg.n_kv, rep, cfg.head_dim).float()
    s = torch.einsum("bgrk,btgk->bgrt", qg, kc.float()) / (cfg.head_dim ** 0.5)
    if cfg.softcap is not None:
        s = cfg.softcap * torch.tanh(s / cfg.softcap)
    s = torch.where(valid[None, None, None, :], s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return m, e.sum(dim=-1, keepdim=True), torch.einsum("bgrt,btgk->bgrk", e,
                                                        vc.float())


def _decode_attention_sharded(q, k_new, v_new, kc, vc, cfg: AttnCfg, pos: int):
    """Decode attention on DTensors, flash-decoding's: q, k_new, v_new (B,
    1, H or Kv, hd); kc, vc (B, Tmax, Kv, hd) DTensors, each rank holding
    its batch rows and a block of the sequence.  Each rank takes its rows
    of q and the token's k and v with every head, writes the token into
    its block of the cache in place when the block holds ``pos``, and
    attends over its keys; the partial softmaxes are combined by
    all-reduces over the mesh dims that split the sequence (max, then the
    sums).  Returns (B, H, hd) float32 at the cache's batch placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = kc.device_mesh
    rows = tuple(Shard(0) if pl == Shard(0) else Replicate()
                 for pl in kc.placements)
    seq_dims = [d for d, pl in enumerate(kc.placements) if pl == Shard(1)]
    ql, kl_new, vl_new = (z.redistribute(mesh, rows).to_local()
                          for z in (q, k_new, v_new))
    kl, vl = kc.to_local(), vc.to_local()
    t0 = shard_offset(kc.shape[1], mesh, kc.placements, 1)
    if t0 <= pos < t0 + kl.shape[1]:
        kl[:, pos - t0] = kl_new[:, 0].to(kl.dtype)
        vl[:, pos - t0] = vl_new[:, 0].to(vl.dtype)
    ids = t0 + torch.arange(kl.shape[1], device=kl.device)
    m, l, acc = _decode_partial(ql[:, 0], kl, vl, ids, cfg, pos)
    scale = torch.exp(m - all_reduce(m, "max", mesh, seq_dims))
    l = all_reduce(l * scale, "sum", mesh, seq_dims)
    acc = all_reduce(acc * scale, "sum", mesh, seq_dims)
    out = acc / l
    B = kc.shape[0]
    shape = (B,) + tuple(out.shape[1:])
    return DTensor.from_local(out, mesh, rows, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def shard_offset(size: int, mesh, placements, dim: int) -> int:
    """The global index of the first element along ``dim`` (of ``size``)
    of this rank's shard at ``placements``: DTensor's chunks (ceil(n / k)
    each, the last ones short or empty), nested in the mesh's dim order."""
    from torch.distributed.tensor import Shard
    coord, off = mesh.get_coordinate(), 0
    for d, pl in enumerate(placements):
        if pl == Shard(dim):
            n = -(-size // mesh.size(d))
            first = min(coord[d] * n, size)
            off, size = off + first, min(n, size - first)
    return off


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    out, n = [], 1
    for size in reversed(shape):
        out.append(n)
        n *= size
    return tuple(reversed(out))


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
    """x (B, T, D) -> (B, T, D): Megatron's MLP on a mesh (`tp_einsum`),
    column-parallel `w_gate` / `w_in`, row-parallel `w_out`."""
    up = lambda w: tp_einsum("btd,df->btf", x, w)
    if act == "swiglu":
        h = F.silu(up(p["w_gate"])) * up(p["w_in"])
    else:
        h = gelu(up(p["w_in"]))
    return tp_einsum("btf,fd->btd", h, p["w_out"])
