"""Unified LM model (the JAX package's `models/model.py`): builds any
architecture of the pool from its ArchConfig, for inference on one card.

Layer stacks are a *super-block program*: a static list of sub-layer
descriptors (mixer kind, FFN kind, attention window) that repeats
n_super = L / len(program) times.  Parameters are stacked (n_super, ...)
per sub-layer, the tree JAX's `Model.init` makes; the forward loops over
the super-blocks with the program unrolled inside, as JAX's `lax.scan`.

Entry points: `forward` / `loss`, `prefill` (last-token logits) and
`decode_step` with `init_cache`; `value_and_grad(model.loss, params,
batch)` is `jax.value_and_grad` of the loss, a gradient for every leaf.
The forward's attention goes through `ops.attention` (K9) and its WKV
through `ops.wkv6` (K8) on ``backend``, with their `autograd.Function`s
when the parameters require grad; decode is plain torch on every backend.

Rematerialisation, as JAX's: with `arch.remat` each sub-layer of a forward
under grad runs under `torch.utils.checkpoint` (non-reentrant), so the
backward keeps only the residual stream between sub-layers and runs each
sub-layer's forward again (K9 and K8 included); `remat_groups` = g > 1
(dividing the super-blocks) also checkpoints each group of n_super / g
super-blocks as a whole.  The numbers do not change.

On a mesh (`models/sharding`, `launch/train --mesh`) the parameters and
the batch are DTensors and every function above runs on them unchanged:
DTensor's sharding rules stand in for GSPMD, and the attention core and
the WKV recurrence run under `local_map`, each rank launching K9 / K8 on
its own heads (`layers.attention`, `rwkv.time_mix`).  JAX's layout hooks,
each None by default or a (DeviceMesh, placements) pair, are applied with
`redistribute` where JAX applies `with_sharding_constraint`, and only to
DTensors: `logits_sharding` (the logits in the loss), `act_sharding` (the
residual stream between sub-layers), `act_inner_sharding` (a sub-layer's
input), `attn_head_sharding` (q, k, v at (B, H, T, d), and the placements
of the attention core), `head_sharding` (RWKV's r, k, v, w at (B, H, T,
K), and the placements of the WKV core; JAX pins them merged, (B*H, T,
K)), `moe_hidden_sharding` (the MoE dispatch in decode) and `pad_heads_to`
(`AttnCfg.pad_heads_to`).  On one device they change nothing.

Decode runs on a mesh too, on DTensor parameters and a cache laid out by
`sharding.batch_pspecs` (the batch over the data-parallel axes, the KV
sequence over "model", or over every axis at batch 1): each super-block's
slot is written in place, the token's K and V only by the rank whose
sequence shard holds ``pos`` (`layers.decode_attention`), and the
attention over a sequence-sharded cache is flash-decoding's: each rank's
partial softmax over its keys, combined by all-reduces of the row max,
the normaliser and the output.  The mamba step runs under `local_map`
as its scan does, its state split over di as JAX's cache spec splits it.

Each sub-layer first gathers its weights' FSDP shards (`layers.
gather_fsdp`, FSDP's gather before use; the tensor-parallel shards stay).
The ops below run under `local_map` on each rank's shard at the layout
JAX's specs imply, their collectives written out, so their layouts do not
depend on DTensor's own strategies, which differ between torch versions:
  * the attention core and the WKV recurrence (`layers.core_placements`:
    the batch where the activations have it, the heads over "model" when
    it does not carry the batch);
  * every weight product, `layers.tp_einsum` (Megatron's layout:
    attention's q, k, v and o, the MLP and qwen2-moe's shared experts,
    the logits head, the frontends' projections, RWKV's and mamba's
    projections; a row-parallel output a partial sum over "model"), and
    MoE's expert einsums (`moe.py`);
  * the residual add, `layers.add_residual` (the sum at the stream's
    layout: a partial sub-layer output reduced once);
  * the token lookup, `layers.embed_lookup` (in the rank's vocab shard,
    the output a partial sum over "model");
  * the loss, `layers.token_nll` (vocab-parallel: each row's max, sum of
    exp and gold logit all-reduced over the vocab shards);
  * mamba's selective scan and decode step, `mamba._ssm` / `_ssm_step`
    (each rank's own di channels, the products over di all-reduced);
  * MoE routing's top-k and one-hot, `moe._route` (every expert's
    probability, which JAX's layout keeps whole too).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from .. import tree
from ..configs.base import ArchConfig, ShapeSpec
from ..kernels import dispatch
from . import layers, mamba, moe, rwkv
from .layers import AttnCfg, Draw

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SubLayer:
    mixer: str                     # attn | mamba | rwkv
    ffn: str                       # dense | moe | none (rwkv has channel-mix)
    window: Optional[int] = None   # static sliding window for this sub-layer


def block_program(arch: ArchConfig) -> List[SubLayer]:
    """The static per-super-block layer pattern of an architecture."""
    if arch.family == "ssm":
        return [SubLayer("rwkv", "none")]
    if arch.attn_period > 0:       # jamba: attn at the middle of each block,
        prog = []                  # MoE on odd sub-layers
        for i in range(arch.attn_period):
            mixer = "attn" if i == arch.attn_period // 2 else "mamba"
            ffn = "moe" if (arch.moe is not None and
                            i % arch.moe_period == arch.moe_period - 1) \
                else "dense"
            prog.append(SubLayer(mixer, ffn))
        return prog
    if arch.alt_local_global:      # gemma2: local (windowed) then global
        return [SubLayer("attn", "dense", window=arch.window),
                SubLayer("attn", "dense", window=None)]
    if arch.moe is not None:
        if arch.moe_period > 1:
            return ([SubLayer("attn", "dense")] * (arch.moe_period - 1)
                    + [SubLayer("attn", "moe")])
        return [SubLayer("attn", "moe")]
    return [SubLayer("attn", "dense", window=arch.window)]


def _attn_cfg(arch: ArchConfig, window, pad_heads_to=None) -> AttnCfg:
    return AttnCfg(n_heads=arch.n_heads, n_kv=arch.n_kv, head_dim=arch.hd,
                   rope_theta=arch.rope_theta, window=window,
                   softcap=arch.softcap_attn, causal=arch.causal,
                   pad_heads_to=pad_heads_to)


def _index(tree, s: int):
    """Super-block ``s`` of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, s) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_index(v, s) for v in tree)
    return tree[s]


def _store(dst, src) -> None:
    """Copy a super-block's new state into its slot of the stacked cache;
    a tensor that is already the slot (the KV cache, written in place) is
    left as it is."""
    if isinstance(dst, dict):
        for k in dst:
            _store(dst[k], src[k])
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _store(d, s)
    elif dst is not src:
        dst.copy_(src)


class Model:
    """Architecture-parameterised model: functions of (params, inputs) and
    the config.  ``device`` is where `init` and `init_cache` put tensors (the
    card unless the caller asks for another); ``backend`` (auto | ref |
    plain | cuda) routes the forward's `ops.attention` and `ops.wkv6`."""

    def __init__(self, arch: ArchConfig, dtype=torch.bfloat16, device=None,
                 backend: dispatch.BackendLike = "auto"):
        self.arch = arch
        self.dtype = dtype
        self.device = dispatch.default_device(device)
        if backend not in (None, "auto"):
            dispatch.Backend(backend)          # raises on an unknown name
        self.backend = backend
        # layout hooks on a mesh, (DeviceMesh, placements) or None (see the
        # module's docstring)
        self.logits_sharding = None
        self.act_sharding = None        # residual stream BETWEEN sub-layers
        self.act_inner_sharding = None  # a sub-layer's input
        self.head_sharding = None       # RWKV's (B, H, T, K) heads
        self.moe_hidden_sharding = None  # decode: pin (B, T, E, F) dispatch
        self.pad_heads_to = None        # TP head padding (see AttnCfg)
        self.attn_head_sharding = None  # (B, H, T, d) q, k, v
        # two-level remat: each group of n_super / remat_groups super-blocks
        # checkpointed as a whole (JAX's `remat_groups`; None: per sub-layer)
        self.remat_groups = None
        self.program = block_program(arch)
        if arch.n_layers % len(self.program):
            raise ValueError(f"{arch.name}: {arch.n_layers} layers are not a "
                             f"multiple of the {len(self.program)}-layer program")
        self.n_super = arch.n_layers // len(self.program)

    # ------------------------------------------------------------------ init
    def _sub_init(self, draw: Draw, sub: SubLayer) -> Params:
        a = self.arch
        D, Fd = a.d_model, a.d_ff
        p: Params = {"ln1": draw.full((D,), 0.0, self.dtype),
                     "ln2": draw.full((D,), 0.0, self.dtype)}
        if sub.mixer == "rwkv":
            p["rwkv"] = rwkv.rwkv_params(draw, D, Fd, a.rwkv, self.dtype)
            return p
        if sub.mixer == "attn":
            p["attn"] = layers.attn_params(draw, D, _attn_cfg(a, None),
                                           self.dtype)
        else:
            p["mamba"] = mamba.mamba_params(draw, D, a.mamba, self.dtype)
        if sub.ffn == "moe":
            p["moe"] = moe.moe_params(draw, D, a.moe, a.act, self.dtype)
        elif sub.ffn == "dense":
            p["mlp"] = layers.mlp_params(draw, D, Fd, a.act, self.dtype)
        return p

    def _init(self, draw: Draw) -> Params:
        a = self.arch
        D = a.d_model
        p: Params = {"embed": draw.normal((a.vocab, D), 0.02, self.dtype),
                     "final_norm": draw.full((D,), 0.0, self.dtype)}
        if not a.tie_embeddings:
            p["head"] = draw.normal((D, a.vocab), 0.02, self.dtype)
        stack = draw.stacked(self.n_super)
        p["blocks"] = {f"sub{i}": self._sub_init(stack, sub)
                       for i, sub in enumerate(self.program)}
        if a.frontend in ("vlm", "audio"):
            p[f"{a.frontend}_proj"] = draw.normal((D, D), 1.0 / (D ** 0.5),
                                                  self.dtype)
        return p

    def init(self, rng: Union[int, torch.Generator] = 0) -> Params:
        """Seeded parameters on the model's device: JAX's tree (keys,
        stacked leaves, shapes, dtypes, distributions and scales) drawn from
        ``rng``, a seed or a `torch.Generator` on that device."""
        if isinstance(rng, int):
            rng = torch.Generator(device=self.device).manual_seed(rng)
        return self._init(Draw(rng, self.device))

    def init_abstract(self) -> Params:
        """The parameter tree as `meta` tensors (shapes and dtypes only)."""
        return self._init(Draw(None, "meta"))

    # -------------------------------------------------------------- sublayer
    def _apply_sub(self, p, x, sub: SubLayer, positions):
        a = self.arch
        p = layers.gather_fsdp(p)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        h = layers.norm(x, p["ln1"], a.norm)
        if sub.mixer == "rwkv":
            tm, _ = rwkv.time_mix(p["rwkv"], h, a.rwkv, backend=self.backend,
                                  head_sharding=self.head_sharding)
            x = layers.add_residual(x, tm)
            cm, _ = rwkv.channel_mix(p["rwkv"], layers.norm(x, p["ln2"], a.norm))
            return layers.add_residual(x, cm), aux
        if sub.mixer == "attn":
            mix = layers.attention(
                p["attn"], h,
                _attn_cfg(a, sub.window, pad_heads_to=self.pad_heads_to),
                positions, backend=self.backend,
                head_sharding=self.attn_head_sharding)
        else:
            mix = mamba.mamba_apply(p["mamba"], h, a.mamba)
        x = layers.add_residual(x, mix)
        h2 = layers.norm(x, p["ln2"], a.norm)
        if sub.ffn == "moe":
            ffn, aux = moe.moe_apply(p["moe"], h2, a.moe)
        else:
            ffn = layers.mlp(p["mlp"], h2, a.act)
        return layers.add_residual(x, ffn), aux

    def _scale_embed(self, x):
        if self.arch.name.startswith("gemma"):
            # the scale rounded to x's dtype first, as jnp.asarray(s, x.dtype)
            x = x * torch.tensor(math.sqrt(self.arch.d_model), dtype=x.dtype,
                                 device=x.device)
        return x

    def _embed(self, params, batch):
        a = self.arch
        if a.frontend == "audio":
            proj = layers.gather_fsdp(params["audio_proj"])
            return layers.tp_einsum("btd,de->bte",
                                    batch["frame_embeds"].to(self.dtype), proj)
        x = self._scale_embed(layers.embed_lookup(params["embed"],
                                                  batch["tokens"]))
        if a.frontend == "vlm":
            pe = layers.tp_einsum("btd,de->bte",
                                  batch["patch_embeds"].to(self.dtype),
                                  layers.gather_fsdp(params["vlm_proj"]))
            x = torch.cat([pe, x[:, a.n_patches:]], dim=1)
        return x

    def _logits(self, params, x):
        a = self.arch
        x = layers.norm(x, params["final_norm"], a.norm)
        head = layers.gather_fsdp(params["embed"]).T if a.tie_embeddings \
            else layers.gather_fsdp(params["head"])
        logits = layers.tp_einsum("btd,dv->btv", x, head)
        if a.softcap_logits is not None:
            logits = a.softcap_logits * torch.tanh(logits / a.softcap_logits)
        return logits

    # ---------------------------------------------------------------- forward
    def _apply_pinned(self, p, x, sub: SubLayer, positions):
        return self._apply_sub(p, layers.pin(x, self.act_inner_sharding), sub,
                               positions)

    def forward(self, params, batch):
        """Full-sequence forward -> (logits (B, T, V), aux_loss)."""
        x = layers.pin(self._embed(params, batch), self.act_sharding)
        positions = torch.arange(x.shape[1], device=x.device)
        remat = self.arch.remat and torch.is_grad_enabled()

        def blocks(first, last, x):
            """Super-blocks first .. last - 1 -> (x, their aux losses)."""
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for s in range(first, last):
                for i, sub in enumerate(self.program):
                    p = _index(params["blocks"][f"sub{i}"], s)
                    if remat:
                        x, a_ = checkpoint(self._apply_pinned, p, x, sub,
                                           positions, use_reentrant=False)
                    else:
                        x, a_ = self._apply_pinned(p, x, sub, positions)
                    x = layers.pin(x, self.act_sharding)
                    aux = aux + a_
            return x, aux

        g = self.remat_groups
        if remat and g and g > 1 and self.n_super % g == 0:
            gs = self.n_super // g
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for j in range(g):
                x, a_ = checkpoint(blocks, j * gs, (j + 1) * gs, x,
                                   use_reentrant=False)
                aux = aux + a_
        else:
            x, aux = blocks(0, self.n_super, x)
        return self._logits(params, x), aux

    def loss(self, params, batch):
        """Mean next-token (masked-unit, encoder-only) cross entropy plus
        the MoE aux loss, as a value."""
        a = self.arch
        logits, aux = self.forward(params, batch)
        logits = layers.pin(logits, self.logits_sharding)
        labels = batch["labels"]
        if a.causal and not a.encoder_only:
            logits = logits[:, :-1]
            labels = labels[:, 1:]
        return layers.token_nll(logits.float(), labels).mean() + aux

    def prefill(self, params, batch):
        """Full-sequence forward returning last-token logits (B, V)."""
        logits, _ = self.forward(params, batch)
        return logits[:, -1]

    # ---------------------------------------------------------------- decode
    def _sub_cache(self, batch: int, max_len: int, sub: SubLayer, device):
        a = self.arch
        if sub.mixer == "rwkv":
            return rwkv.init_rwkv_state(batch, a.d_model, a.rwkv, self.dtype,
                                        device)
        if sub.mixer == "mamba":
            return mamba.init_mamba_state(batch, a.d_model, a.mamba,
                                          self.dtype, device)
        return {k: torch.zeros((batch, max_len, a.n_kv, a.hd), dtype=self.dtype,
                               device=device) for k in ("k", "v")}

    def init_cache(self, batch: int, max_len: int, device=None):
        """Stacked decode state: {sub_i: (n_super, ...)}, zeros."""
        device = self.device if device is None else device

        def stack(c):
            if isinstance(c, dict):
                return {k: stack(v) for k, v in c.items()}
            if isinstance(c, tuple):
                return tuple(stack(v) for v in c)
            return c[None].repeat((self.n_super,) + (1,) * c.dim())
        return {f"sub{i}": stack(self._sub_cache(batch, max_len, sub, device))
                for i, sub in enumerate(self.program)}

    def _decode_sub(self, p, x, cch, sub: SubLayer, pos):
        a = self.arch
        p = layers.gather_fsdp(p)
        h = layers.norm(x, p["ln1"], a.norm)
        if sub.mixer == "rwkv":
            tm, (tshift, wkv_s) = rwkv.time_mix(
                p["rwkv"], h, a.rwkv, shift_state=cch["tm_shift"],
                wkv_state=cch["wkv"])
            x = layers.add_residual(x, tm)
            cm, cshift = rwkv.channel_mix(
                p["rwkv"], layers.norm(x, p["ln2"], a.norm),
                shift_state=cch["cm_shift"])
            return layers.add_residual(x, cm), {
                "tm_shift": tshift, "cm_shift": cshift, "wkv": wkv_s}
        if sub.mixer == "attn":
            mix, new_c = layers.decode_attention(
                p["attn"], h, _attn_cfg(a, sub.window), cch, pos)
        else:
            mix, new_c = mamba.mamba_decode(p["mamba"], h, cch, a.mamba)
        x = layers.add_residual(x, mix)
        h2 = layers.norm(x, p["ln2"], a.norm)
        if sub.ffn == "moe":
            ffn, _ = moe.moe_apply(p["moe"], h2, a.moe,
                                   hidden_sharding=self.moe_hidden_sharding)
        else:
            ffn = layers.mlp(p["mlp"], h2, a.act)
        return layers.add_residual(x, ffn), new_c

    def decode_step(self, params, cache, tokens, pos):
        """tokens (B, 1); pos the tokens' index -> (logits (B, V), cache).

        The cache is updated in place (each super-block's slot of the
        stacked tensors) and returned."""
        x = self._scale_embed(layers.embed_lookup(params["embed"], tokens))
        for s in range(self.n_super):
            for i, sub in enumerate(self.program):
                slot = _index(cache[f"sub{i}"], s)
                x, new_c = self._decode_sub(
                    _index(params["blocks"][f"sub{i}"], s), x, slot, sub, pos)
                _store(slot, new_c)
        return self._logits(params, x)[:, 0], cache

    # ----------------------------------------------------------------- specs
    def input_specs(self, shape: ShapeSpec):
        """`meta` tensors standing in for every model input of a cell."""
        a = self.arch
        B, T = shape.global_batch, shape.seq_len
        meta = torch.device("meta")
        spec = lambda s, dt: torch.empty(s, dtype=dt, device=meta)
        if shape.kind in ("train", "prefill"):
            batch = {"tokens": spec((B, T), torch.int32)}
            if a.frontend == "vlm":
                batch["patch_embeds"] = spec((B, a.n_patches, a.d_model),
                                             self.dtype)
            if a.frontend == "audio":
                batch["frame_embeds"] = spec((B, T, a.d_model), self.dtype)
            if shape.kind == "train":
                batch["labels"] = spec((B, T), torch.int32)
            return batch
        return {"cache": self.init_cache(B, T, device=meta),
                "tokens": spec((B, 1), torch.int32),
                "pos": spec((), torch.int32)}


def value_and_grad(fn, params, *args):
    """(fn(params, *args), its gradient): `jax.value_and_grad` for a tree of
    floating parameter tensors.  The gradient is a tree of ``params``'
    structure, each leaf in its parameter's dtype (zeros where the value
    does not depend on the leaf, as JAX gives).  ``params`` itself is left
    as it is (the function sees detached leaves that require grad).  On a
    mesh (DTensor leaves) the value is made whole, a plain scalar on every
    rank, before the backward, and each gradient is a DTensor on whatever
    placements autograd gives it."""
    xs = [t.detach().requires_grad_() for t in tree.leaves(params)]
    with torch.enable_grad():
        value = fn(tree.unflatten(params, xs), *args)
        if layers.is_dtensor(value):
            value = value.full_tensor()
        grads = torch.autograd.grad(value, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads)]
    return value.detach(), tree.unflatten(params, grads)


def count_params(model: Model) -> Tuple[int, int]:
    """(total, active) parameter counts from the abstract tree.

    Active scales routed-expert weights by top_k / n_experts (MoE cells
    report MODEL_FLOPS = 6 * N_active * D)."""
    a = model.arch
    total = 0
    active = 0.0
    for path, leaf in tree.flatten_with_path(model.init_abstract()):
        n = leaf.numel()
        total += n
        keys = [name for _, name in path]
        if "moe" in keys and "shared" not in keys and any(
                k in ("w_gate", "w_in", "w_out") for k in keys):
            active += n * (a.moe.top_k / a.moe.n_experts)
        else:
            active += n
    return total, int(active)
