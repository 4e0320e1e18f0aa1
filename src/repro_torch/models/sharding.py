"""Sharding rules: parameter / optimizer / batch PartitionSpecs per arch (the
JAX package's `models/sharding.py`), and their DTensor placements.

Default layout on the production mesh:
  * data parallel over ("pod", "data") for batches,
  * tensor parallel over "model": attention heads, MLP hidden, expert dim
    (EP) where divisible — qwen2's 60 experts fall back to FF-dim TP,
  * decode KV caches: batch over DP axes, sequence over "model"
    (flash-decode combine; long_500k shards the sequence over data+model),
  * ZeRO-1 flag: optimizer moments additionally sharded over "data" on the
    first divisible unsharded dim.

A dim is only sharded when its size divides the axis size — otherwise the
spec falls back to replication for that dim (no uneven padding).

A spec is a `PartitionSpec`, a tuple with one entry a tensor dim: None, an
axis name, or a tuple of axis names.  `placements` turns it into DTensor's
form, one `Shard(d)` or `Replicate()` per mesh dim, and `distribute` lays a
tree out by a tree of specs.  The rules read only the mesh's axis names and
sizes: a `launch.mesh.MeshSpec` or a `DeviceMesh`.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

from .. import tree as T
from ..configs.base import ArchConfig, ShapeSpec
from ..launch.mesh import axis_names, axis_sizes, shard
from .model import Model


class PartitionSpec(tuple):
    """JAX's `PartitionSpec`: per tensor dim None, an axis name, or a tuple
    of axis names.  A leaf of the port's trees (`tree.py`)."""
    tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _div(n: int, mesh_shape: Dict[str, int], axis) -> bool:
    if axis is None:
        return True
    if isinstance(axis, tuple):
        size = 1
        for a in axis:
            size *= mesh_shape[a]
    else:
        size = mesh_shape[axis]
    return n % size == 0


def _spec_for(path_keys: Tuple[str, ...], shape: Tuple[int, ...],
              mesh_shape: Dict[str, int], tp) -> P:
    """Parameter partition spec by name/shape pattern (pre-stacking)."""
    name = path_keys[-1]
    ndim = len(shape)

    def m(dim_idx, axis):
        return axis if _div(shape[dim_idx], mesh_shape, axis) else None

    if name in ("embed",):                       # (V, D)
        return P(m(0, tp), None)
    if name in ("head",):                        # (D, V)
        return P(None, m(1, tp))
    if name in ("vlm_proj", "audio_proj"):
        return P(None, m(1, tp))
    if name in ("wq", "wk", "wv"):               # (D, H, hd)
        return P(None, m(1, tp), None)
    if name == "wo":                             # (H, hd, D)
        return P(m(0, tp), None, None)
    if "moe" in path_keys and "shared" not in path_keys and \
            name in ("w_gate", "w_in"):          # (E, D, F)
        if _div(shape[0], mesh_shape, tp):
            return P(tp, None, None)             # expert parallel
        return P(None, None, m(2, tp))           # TP fallback (qwen2)
    if "moe" in path_keys and "shared" not in path_keys and \
            name == "w_out":                     # (E, F, D)
        if _div(shape[0], mesh_shape, tp):
            return P(tp, None, None)
        return P(None, m(1, tp), None)
    if name == "router":
        return P(None, None)
    if name in ("w_gate", "w_in", "w_ck", "w_cr", "w_r", "w_k", "w_v"):
        # (D, F)-like: shard the hidden/output dim
        return P(None, m(1, tp)) if ndim == 2 else P(*([None] * ndim))
    if name in ("w_out", "w_cv", "w_o"):         # (F, D)-like
        return P(m(0, tp), None) if ndim == 2 else P(*([None] * ndim))
    if name == "w_xdt":                          # mamba (di, rank)
        return P(m(0, tp), None)
    # mamba
    if name == "conv_w":                         # (k, di)
        return P(None, m(1, tp))
    if name in ("conv_b", "dt_bias", "D", "decay", "bonus"):
        return P(m(0, tp)) if ndim == 1 else P(*([None] * ndim))
    if name in ("w_B", "w_C", "A_log"):          # (di, N)
        return P(m(0, tp), None)
    if name == "w_dt":                           # (rank, di)
        return P(None, m(1, tp))
    if name == "w_dd1":                          # (D, lora)
        return P(None, None)
    if name == "w_dd2":
        return P(None, None)
    return P(*([None] * ndim))                   # norms, mixes, scalars


def strategy_for(arch: ArchConfig, mesh, global_batch: int = 0):
    """(tp_axis, dp_axes) for an arch on a mesh.

    Attention-free archs whose head count doesn't divide the model axis
    (rwkv6: 40 heads vs 16) get NO tensor parallelism: every sharding of the
    WKV head dim is either uneven or needs a full reshard, so the right
    layout is pure data parallelism over ALL axes (weights FSDP-gathered
    per layer).  Everything else: TP over `model`, DP over pod+data.
    ``REPRO_SSM_TP=1`` gives the SSM family TP over `model` too."""
    all_axes = axis_names(mesh)
    sizes = axis_sizes(mesh)
    dp_default = tuple(a for a in all_axes if a != "model")
    if os.environ.get("REPRO_SSM_TP", "0") == "1":
        return "model", dp_default
    if arch.family == "ssm":
        # fold `model` into DP: pick the largest axis combination that the
        # batch divides (multi-pod: 256 % 512 != 0, but 256 % ("data",
        # "model")=256 == 0 — replicate over "pod" rather than wasting the
        # model axis)
        candidates = [all_axes,
                      tuple(a for a in all_axes if a != "pod"),
                      dp_default, (dp_default[-1],)]
        for cand in candidates:
            size = 1
            for a in cand:
                size *= sizes[a]
            if global_batch and global_batch % size == 0:
                return None, cand
        return None, dp_default
    return "model", dp_default


def _keys(path) -> Tuple[str, ...]:
    """A `tree` path as JAX's key names: a dict key bare, an index "[i]"."""
    return tuple(str(name) if kind != "idx" else f"[{name}]"
                 for kind, name in path)


def _map_with_path(fn, tree):
    paths = T.flatten_with_path(tree)
    return T.unflatten(tree, [fn(p, leaf) for p, leaf in paths])


def param_pspecs(model: Model, mesh, tp="model", fsdp="data") -> Any:
    """PartitionSpec tree matching model.init_abstract().

    fsdp: additionally shard the first remaining divisible dim of each >=2D
    weight over the data axis (ZeRO-3 / FSDP: the weights are gathered per
    layer, so per-device parameter memory drops by the data-axis size)."""
    mesh_shape = axis_sizes(mesh)

    def one(path, leaf):
        keys = _keys(path)
        stacked = "blocks" in keys
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        spec = _spec_for(keys, shape, mesh_shape, tp)
        if fsdp is not None and len(shape) >= 2:
            entries = list(spec) + [None] * (len(shape) - len(spec))
            for i, (e, n) in enumerate(zip(entries, shape)):
                if e is None and n % mesh_shape[fsdp] == 0 and \
                        n >= mesh_shape[fsdp]:
                    entries[i] = fsdp
                    break
            spec = P(*entries)
        if stacked:
            spec = P(None, *spec)
        return spec

    return _map_with_path(one, model.init_abstract())


def opt_pspecs(param_specs: Any, abstract_params: Any, mesh,
               zero1: bool = True, dp="data") -> Any:
    """Moment specs: same as params, plus ZeRO-1 sharding of the first
    divisible unsharded dim over the data axis."""
    mesh_shape = axis_sizes(mesh)

    def one(spec: P, leaf):
        if not zero1:
            return spec
        entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
        flat = [e for ent in entries if ent is not None
                for e in (ent if isinstance(ent, tuple) else (ent,))]
        if dp in flat:        # already data-sharded (FSDP params)
            return P(*entries)
        for i, (s, n) in enumerate(zip(entries, leaf.shape)):
            if s is None and n % mesh_shape[dp] == 0 and n >= mesh_shape[dp]:
                entries[i] = dp
                break
        return P(*entries)

    return T.unflatten(param_specs, [one(s, leaf) for s, leaf in zip(
        T.leaves(param_specs), T.leaves(abstract_params))])


def batch_pspecs(model: Model, shape: ShapeSpec, mesh, dp=("data",),
                 tp="model") -> Any:
    """Input specs for a cell; dp is a tuple of data-parallel axis names."""
    a = model.arch
    mesh_shape = axis_sizes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    if not _div(shape.global_batch, mesh_shape, dpa):
        dpa = dp[0] if _div(shape.global_batch, mesh_shape, dp[0]) else None
    if shape.kind in ("train", "prefill"):
        out = {"tokens": P(dpa, None)}
        if a.frontend == "vlm":
            out["patch_embeds"] = P(dpa, None, None)
        if a.frontend == "audio":
            out["frame_embeds"] = P(dpa, None, None)
        if shape.kind == "train":
            out["labels"] = P(dpa, None)
        return out

    # decode: shard cache batch over dp; sequence over tp (flash-decode).
    # long-context (batch 1): sequence over (dp, tp) combined.
    seq_axes = tp if shape.global_batch > 1 else tuple(dp) + (tp,)
    bat_axes = dpa if shape.global_batch > 1 else None

    def cache_spec(path, leaf):
        keys = _keys(path)
        nd = len(leaf.shape)
        name = keys[-1]
        if name in ("k", "v"):           # (n_super, B, T, Kv, hd)
            sa = seq_axes if _div(leaf.shape[2], mesh_shape, seq_axes) else None
            return P(None, bat_axes, sa, None, None)
        if name == "wkv":                # (n_super, B*H, K, K)
            return P(None, bat_axes, None, None)
        if name in ("tm_shift", "cm_shift"):   # (n_super, B, 1, D)
            return P(None, bat_axes, None, None)
        if nd == 4 and a.mamba is not None and \
                leaf.shape[-1] == a.mamba.d_state:
            # mamba ssm state (n_super, B, di, N)
            di_ax = tp if _div(leaf.shape[2], mesh_shape, tp) else None
            return P(None, bat_axes, di_ax, None)
        if nd == 4:                      # mamba conv state (n_super,B,k,di)
            di_ax = tp if _div(leaf.shape[3], mesh_shape, tp) else None
            return P(None, bat_axes, None, di_ax)
        return P(*([None] * nd))

    cache = model.init_cache(shape.global_batch, shape.seq_len, device="meta")
    return {"cache": _map_with_path(cache_spec, cache),
            "tokens": P(bat_axes, None), "pos": P()}


# ---------------------------------------------------------------------------
# DTensor layouts
# ---------------------------------------------------------------------------
def placements(spec, mesh, ndim: int) -> tuple:
    """DTensor placements of ``spec`` for a tensor of ``ndim`` dims: one
    entry a mesh dim, `Shard(d)` where spec dim d names that mesh axis and
    `Replicate()` where none does.

    A tensor dim sharded over a tuple of axes is `Shard(d)` on each of
    their mesh dims.  DTensor nests such shards in the mesh's dim order,
    the first mesh dim outermost; JAX nests them in the tuple's order, the
    first axis outermost.  The two agree when the tuple names its axes in
    the mesh's order, as every rule above does (("pod", "data"), ("data",
    "model")); a tuple in another order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    entries = list(spec) + [None] * (ndim - len(spec))
    if len(entries) != ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    out = [Replicate()] * len(names)
    for d, ent in enumerate(entries):
        if ent is None:
            continue
        axes = ent if isinstance(ent, tuple) else (ent,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec} names axis {names[i]} twice")
            out[i] = Shard(d)
    return tuple(out)


def distribute(tree, specs, mesh):
    """``tree`` (the same whole tensors on every rank: a seeded init, or a
    file every rank reads) laid out on ``mesh`` by ``specs``: each leaf a
    DTensor on the mesh's device type, each rank keeping only its shard.
    No communication."""
    return T.unflatten(tree, [shard(t, mesh, placements(s, mesh, t.dim()))
                              for t, s in zip(T.leaves(tree), T.leaves(specs))])
