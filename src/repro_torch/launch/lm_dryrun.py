"""LM cells of the multi-rank dry run (the JAX package's `launch/dryrun.py`:
`lower_cell` and `compile_and_analyze`).

JAX jit-lowers each cell's step (train: `value_and_grad` of the loss and
AdamW; prefill; decode) for the production mesh on 512 spoofed devices,
compiles it, and reads a device's memory, cost and collectives from XLA.
The port has no compiler.  `trace_cell(arch, shape, spec)` runs rank 0's
step on a fake group of the mesh's size (`launch/mesh.py:
init_fake_group`) over a `DeviceMesh`, with every parameter, moment, batch
and cache a DTensor laid out by JAX's rules (`models/sharding.py`) whose
local shard is a fake tensor (`FakeTensorMode`'s: full-size weights need no
memory; the mode itself is not entered during the step, so that DTensor's
own index arithmetic runs on real tensors while every op on a shard runs
fake), the layout hooks and options set where JAX's `lower_cell` sets
them, and counts what that rank's program pays (`RankCounter`):

  * only the rank's own ops: an op with DTensor operands is deferred to
    DTensor, which runs the rank's local ops (counted) and its collectives;
    the ops DTensor's sharding propagation runs at the global shape
    (`ShardingPropagator`'s tensor-meta propagation, on a cache miss) are
    left out, so the count does not depend on what ran before;
  * bytes and flops of each local aten op, as `ocean_dryrun.StepCounter`
    counts them, under the source tags of the open ranges (`SOURCE_TAGS`:
    the port's three ops that run on each rank's shard under `local_map`
    with their collectives written out as JAX's GSPMD program has them,
    by their own names, then JAX's tags): `layers.embed_lookup` (the
    lookup in the rank's vocab shard; the shard's FSDP gather over "data";
    the sum over "model" falls to the next op), `layers.token_nll` (the
    all-reduces of each row's max, sum of exp and gold logit over the
    vocab shards) and `mamba._ssm` (the scan of the rank's di channels;
    the all-reduces of the products over di to dt's rank, B and C).
    MoE's routing (`moe._route`) moves nothing (its probabilities' expert
    dim is whole in JAX's layout too), so its bytes count under
    `moe_apply`;
  * K9 and K8 by their formulas (`roofline/kernels.py`) through
    `kernels/ops.py: tapped`, called through their custom ops on either
    device, so only the ops' fakes run and the plain version's (T, T)
    scores are counted nowhere, the peak included.  Their backwards (the
    port of JAX's `_bwd_rule`, `models/attention.py`, and the gradient of
    the chunked WKV, `models/rwkv.py`) are the port's real program and are
    counted as ordinary ops;
  * collectives: DTensor's functional collectives (`_c10d_functional`,
    and `_dtensor.shard_dim_alltoall`) under JAX's kind names, their
    bytes JAX's: the result's buffer, twice for an all-reduce; also by
    source tag (``hlo.coll_by_source``);
  * memory: the rank's arguments (parameters, AdamW moments and step,
    batch; or parameters, cache, tokens), its outputs, and the step's peak by
    `torch.distributed._tools.mem_tracker.MemTracker` with the arguments
    tracked.  Train and decode update their state in place (JAX donates
    it), so those outputs alias the arguments.

Mamba's scan is traced one chunk for its trip count (`ops.counted`, as
JAX's HLO analysis counts a while loop's body).  On the card the same
trace runs on fake CUDA tensors: nothing is launched, and the record
equals the CPU's in bytes, flops and arguments (`chip_smoke.py` phase 13
runs each recorded K9 / K8 call through the kernel at its local shape).

`launch/dryrun.py` writes the record (JAX's keys; roofline on the H100
model at bf16).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape train_4k --mesh single --device cpu
"""
from __future__ import annotations

import collections
import contextlib
import math
import os
import time
from typing import Dict

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

from .. import tree as T
from ..configs import get_arch
from ..configs.base import SHAPES
from ..kernels import dispatch, ops
from ..models import layers, sharding
from ..models.model import Model, count_params, value_and_grad
from ..obs import trace as _trace
from ..optim import adamw
from ..roofline import analysis
from ..roofline import kernels as rk
from .mesh import MeshSpec, axis_sizes, init_fake_group, is_dtensor, make_mesh
from .ocean_dryrun import (_NO_TRAFFIC, StepCounter, StepTrace, _tensors,
                           card_info)

# the port's ops whose collectives `local_map` writes out (`models/model.py`):
# an all-reduce of a shard's statistics or of a partial product, and the
# FSDP gather of the embedding's vocab shard; reported under their own
# tags, ahead of JAX's
PORT_TAGS = ("layers.embed_lookup", "layers.token_nll", "mamba._ssm")
SOURCE_TAGS = PORT_TAGS + analysis.SOURCE_TAGS
# the port's ranges that stand for a source tag (``kops.<op>`` by its op)
RANGE_TAGS = {"kops.wkv6": "wkv", "rwkv.wkv_backward": "wkv",
              "kops.attention": "flash_attention",
              "attention.backward": "flash_attention", "mamba": "mamba",
              "moe_apply": "moe_apply", "adamw": "adamw",
              **{t: t for t in PORT_TAGS}}
# DTensor's collectives, by JAX's kind names
COLLECTIVES = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
}
# the kernel each custom op launches
CUSTOM_OPS = {"repro_torch::flash_attention": "flash_attention",
              "repro_torch::flash_attention_stats": "flash_attention",
              "repro_torch::wkv6": "wkv6"}


def source_tag() -> str:
    """The first of `SOURCE_TAGS` that the open ranges name, else "other"."""
    names = set()
    for r in _trace.open_ranges():
        key = ".".join(r.split(".")[:2]) if r.startswith("kops.") else r
        if key in RANGE_TAGS:
            names.add(RANGE_TAGS[key])
    return next((t for t in SOURCE_TAGS if t in names), "other")


class RankCounter(StepCounter):
    """`StepCounter` of one rank of a DTensor program (see the module
    docstring): DTensor ops deferred, sharding propagation left out,
    collectives and the custom ops' launches counted, each K9 / K8 call's
    local shapes kept."""

    def __init__(self):
        super().__init__()
        self.propagating = 0
        self.launches: collections.Counter = collections.Counter()
        self.coll_by_source: Dict[str, float] = {}
        self.flops_by_source: Dict[str, float] = {}
        self.calls: collections.Counter = collections.Counter()

    def tag(self) -> str:
        return source_tag()

    def _tag_flops(self, f0: float) -> None:
        """Put the flops counted since ``f0`` under the current tag."""
        tag = self.tag()
        self.flops_by_source[tag] = (self.flops_by_source.get(tag, 0.0)
                                     + self.stats.flops - f0)

    @contextlib.contextmanager
    def kernel(self, name: str, operands):
        shapes = tuple(tuple(x.shape) for x in operands
                       if isinstance(x, torch.Tensor))
        dtype = str(operands[0].dtype).replace("torch.", "")
        opts = tuple(x for x in operands if not isinstance(x, torch.Tensor))
        self.calls[(name, shapes, dtype, opts)] += ops.weight()
        f0 = self.stats.flops
        with super().kernel(name, operands):
            self._tag_flops(f0)
            yield

    def count(self, func, args, kwargs, out, w: int) -> None:
        f0 = self.stats.flops
        super().count(func, args, kwargs, out, w)
        self._tag_flops(f0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.propagating:        # DTensor's global-shape propagation
            return func(*args, **kwargs)
        if any(is_dtensor(x) for x in tree_leaves((args, kwargs))):
            return NotImplemented   # DTensor runs the rank's local ops
        out = func(*args, **kwargs)
        name, w = func._schema.name, ops.weight()
        if name in COLLECTIVES:
            self.collective(COLLECTIVES[name], rk.nbytes(*_tensors(out)), w)
        elif name in CUSTOM_OPS:
            self.launches[CUSTOM_OPS[name]] += w
        elif not (self._in_body or func.namespace != "aten" or func.is_view
                  or func.overloadpacket in _NO_TRAFFIC):
            self.count(func, args, kwargs, out, w)
        return out

    def collective(self, kind: str, buf: int, w: int) -> None:
        """One collective of a ``buf``-byte result, ``w`` times: JAX's wire
        bytes (twice the buffer for an all-reduce) and the buffer's HBM
        bytes."""
        if not w:
            return
        st, tag = self.stats, self.tag()
        cb = w * (2 if kind == "all-reduce" else 1) * buf
        st.coll_bytes += cb
        st.n_collectives += w
        st.coll_by_kind[kind] = st.coll_by_kind.get(kind, 0.0) + cb
        self.coll_by_source[tag] = self.coll_by_source.get(tag, 0.0) + cb
        st.add_bytes(w * buf, tag)

    def kernel_record(self) -> Dict[str, dict]:
        """{kernel: calls, launches, bytes, flops, and each distinct call
        (its operands' local shapes, dtype, options and count)}."""
        out = {}
        for name, k in self.kernels.items():
            out[name] = dict(k, launches=int(self.launches[name]), shapes=[
                dict(shapes=[list(s) for s in shp], dtype=dt,
                     options=list(opts), calls=int(n))
                for (kn, shp, dt, opts), n in self.calls.items() if kn == name])
        return out


@contextlib.contextmanager
def _propagation_marked(counter: RankCounter):
    """While active, DTensor's tensor-meta propagation (the op at the
    global shape on fake tensors) runs with ``counter.propagating`` set."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = next(n for n in ("_propagate_tensor_meta_non_cached",
                            "_propagate_tensor_meta")
                if hasattr(ShardingPropagator, n))
    orig = getattr(ShardingPropagator, name)

    def marked(self, *args, **kwargs):
        counter.propagating += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            counter.propagating -= 1
    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


@contextlib.contextmanager
def _alltoall_as_on_cuda(device_type: str):
    """On a CPU mesh, DTensor's shard-to-shard redistribution as on a CUDA
    one: its all-to-all op (gloo has none, so DTensor would all-gather
    and slice), so that both devices trace the same rank program."""
    from torch.distributed.tensor import placement_types as pt
    if device_type != "cpu" or not hasattr(pt, "shard_dim_alltoall"):
        yield
        return
    import torch.distributed._functional_collectives as funcol
    orig = pt.shard_dim_alltoall

    def alltoall(x, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            x, gather_dim, shard_dim, funcol._group_or_group_name(group))
    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


# ---------------------------------------------------------------------------
# the cell's layout (JAX's `lower_cell`, `launch/dryrun.py:44-153`)
# ---------------------------------------------------------------------------
def set_hooks(model: Model, shape, mesh, tp, dp) -> dict:
    """Set the model's layout hooks and options where JAX's `lower_cell`
    sets them (`REPRO_SEQ_PARALLEL`, `REPRO_REMAT_GROUPS`,
    `REPRO_MOE_DECODE_PIN`, `REPRO_PAD_HEADS`); returns the options set."""
    arch, sizes = model.arch, axis_sizes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]

    def hook(entries, ndim):
        return mesh, sharding.placements(sharding.P(*entries), mesh, ndim)
    model.logits_sharding = hook(
        (dpa, None, tp if tp and arch.vocab % sizes[tp] == 0 else None), 3)
    seq_par = (os.environ.get("REPRO_SEQ_PARALLEL", "0") == "1"
               and tp is not None and shape.kind in ("train", "prefill")
               and shape.seq_len % sizes[tp] == 0)
    model.act_sharding = hook((dpa, tp if seq_par else None, None), 3)
    if seq_par:
        model.act_inner_sharding = hook((dpa, None, None), 3)
    opts = dict(seq_parallel=seq_par)
    if (os.environ.get("REPRO_REMAT_GROUPS", "1") == "1"
            and shape.kind == "train"):
        ns = model.n_super
        target = int(math.sqrt(ns)) or 1
        divs = [d for d in range(1, ns + 1) if ns % d == 0]
        model.remat_groups = min(divs, key=lambda d: abs(d - target))
        opts["remat_groups"] = model.remat_groups
    if (os.environ.get("REPRO_MOE_DECODE_PIN", "1") == "1"
            and shape.kind == "decode" and arch.moe is not None
            and tp is not None and arch.moe.n_experts % sizes[tp] == 0):
        model.moe_hidden_sharding = hook((None, None, tp, "data"), 4)
        opts["moe_decode_pin"] = True
    if (tp is not None and arch.n_heads % sizes[tp] != 0
            and os.environ.get("REPRO_PAD_HEADS", "1") == "1"):
        model.pad_heads_to = -(-arch.n_heads // sizes[tp]) * sizes[tp]
        model.attn_head_sharding = hook((dpa, tp, None, None), 4)
        opts["pad_heads_to"] = model.pad_heads_to
    return opts


def fake_dtensor(meta: torch.Tensor, spec, mesh, fake_mode, device):
    """A DTensor of ``meta``'s shape and dtype at ``spec`` on ``mesh``
    whose local shard is a fake tensor on ``device``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    pl = sharding.placements(spec, mesh, meta.dim())
    local_shape, _ = compute_local_shape_and_global_offset(meta.shape, mesh, pl)
    with fake_mode:
        local = torch.empty(local_shape, dtype=meta.dtype, device=device)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=meta.shape,
                              stride=layers.contiguous_stride(meta.shape))


def fake_tree(metas, specs, mesh, fake_mode, device):
    return T.unflatten(metas, [fake_dtensor(m, s, mesh, fake_mode, device)
                               for m, s in zip(T.leaves(metas),
                                               T.leaves(specs))])


def _local(x):
    return x.to_local() if is_dtensor(x) else x


def argument_leaves(groups) -> Dict[str, dict]:
    """{name: {"elements", "bytes"}} of a rank's arguments: each group's
    leaves (local shards) in JAX's order, named ``<group><keystr>``."""
    out = {}
    for group, tree_ in groups:
        for path, x in T.flatten_with_path(tree_):
            x = _local(x)
            out[group + T.keystr(path)] = dict(
                elements=x.numel(), bytes=x.numel() * x.element_size())
    return out


def _micro_rows(x, i: int, mb: int):
    """Microbatch ``i`` of ``mb`` of a batch leaf: each rank's own rows,
    split in ``mb`` (JAX slices the global batch; the summed gradient is
    the same)."""
    from torch.distributed.tensor import DTensor
    if not is_dtensor(x):
        n = x.shape[0] // mb
        return x[i * n:(i + 1) * n]
    loc = x.to_local()
    if loc.shape[0] % mb:
        raise ValueError(f"REPRO_MICROBATCH={mb} does not divide a rank's "
                         f"{loc.shape[0]} rows")
    n = loc.shape[0] // mb
    shape = (x.shape[0] // mb,) + tuple(x.shape[1:])
    return DTensor.from_local(loc[i * n:(i + 1) * n], x.device_mesh,
                              x.placements, run_check=False, shape=shape,
                              stride=layers.contiguous_stride(shape))


def train_step_of(model: Model, global_batch: int):
    """JAX's `train_step`: the loss's value and gradient (accumulated over
    `REPRO_MICROBATCH` microbatches in float32 when it divides the batch),
    then AdamW, in place (JAX donates the state)."""
    mb = int(os.environ.get("REPRO_MICROBATCH", "1"))

    def step(params, opt, batch):
        if mb > 1 and global_batch % mb == 0:
            gacc, loss = None, 0.0
            for i in range(mb):
                micro = {k: _micro_rows(v, i, mb) for k, v in batch.items()}
                li, g = value_and_grad(model.loss, params, micro)
                g = [x.float() / mb for x in T.leaves(g)]
                gacc = g if gacc is None else [a + b for a, b in zip(gacc, g)]
                loss = loss + li / mb
            grads = T.unflatten(params, gacc)
        else:
            loss, grads = value_and_grad(model.loss, params, batch)
        with _trace.annotate("adamw"):
            adamw.update(grads, opt, params, inplace=True)
        return loss
    return step


def trace_cell(arch_name: str, shape_name: str, spec: MeshSpec, device=None,
               zero1: bool = True, verbose: bool = False) -> dict:
    """The dry-run record of rank 0 of ``arch_name`` x ``shape_name`` on
    ``spec`` (JAX's `lower_cell` + `compile_and_analyze`), traced on
    ``device`` (the card unless the caller asks for the CPU) on a fake
    group of ``spec.size`` ranks, which it starts and destroys when none is
    initialized.  ``zero1``: the AdamW moments also sharded over "data"."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from . import dryrun
    device = dispatch.default_device(device)
    own = not dist.is_initialized()
    if own:
        init_fake_group(spec.size)
    try:
        if (str(dist.get_backend()).lower() != "fake"
                or dist.get_world_size() != spec.size):
            raise RuntimeError(f"trace_cell needs a fake group of "
                               f"{spec.size} ranks")
        mesh = make_mesh(spec, device.type)
        fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        arch, shape = get_arch(arch_name), SHAPES[shape_name]
        model = Model(arch, dtype=torch.bfloat16, device=device,
                      backend="plain" if device.type == "cpu" else "auto")
        tp, dp = sharding.strategy_for(arch, spec, shape.global_batch)
        opts = set_hooks(model, shape, mesh, tp, dp)
        metas = model.init_abstract()
        pspecs = sharding.param_pspecs(model, spec, tp=tp)
        params = fake_tree(metas, pspecs, mesh, fake_mode, device)
        bspecs = sharding.batch_pspecs(model, shape, spec, dp=dp,
                                       tp=tp or "model")
        babs = model.input_specs(shape)
        if shape.kind == "train":
            ospecs = sharding.opt_pspecs(pspecs, metas, spec, zero1=zero1)
            f32 = T.unflatten(metas, [torch.empty(m.shape, dtype=torch.float32,
                                                  device="meta")
                                      for m in T.leaves(metas)])
            opt = adamw.AdamWState(
                m=fake_tree(f32, ospecs, mesh, fake_mode, device),
                v=fake_tree(f32, ospecs, mesh, fake_mode, device),
                step=torch.zeros((), dtype=torch.int32, device=device))
            batch = fake_tree(babs, bspecs, mesh, fake_mode, device)
            groups = (("params", params), ("opt", opt), ("batch", batch))
            train = train_step_of(model, shape.global_batch)
            run = lambda: train(params, opt, batch)
            aliased = ("params", "opt")
        elif shape.kind == "prefill":
            batch = fake_tree(babs, bspecs, mesh, fake_mode, device)
            groups = (("params", params), ("batch", batch))
            run = lambda: model.prefill(params, batch)
            aliased = ()
        else:
            cache = fake_tree(babs["cache"], bspecs["cache"], mesh, fake_mode,
                              device)
            tokens = fake_dtensor(babs["tokens"], bspecs["tokens"], mesh,
                                  fake_mode, device)
            # a full cache: the last slot.  A Python int, as the JAX
            # package's compiled decode holds no argument for it
            pos = shape.seq_len - 1
            groups = (("params", params), ("cache", cache), ("tokens", tokens))
            run = lambda: model.decode_step(params, cache, tokens, pos)[0]
            aliased = ("cache",)
        traced = trace_rank(run, groups, aliased, device)
    finally:
        if own:
            dist.destroy_process_group()
    n_total, n_active = count_params(model)
    aux = dict(arch=arch_name, shape=shape_name, n_params=n_total,
               n_params_active=n_active,
               model_flops=analysis.model_flops_estimate(arch, shape, n_total,
                                                         n_active),
               tp=tp, dp=list(dp), zero1=zero1, options=opts)
    return dryrun.analyze(traced, aux, spec, verbose=verbose)


def trace_rank(run, groups, aliased, device) -> StepTrace:
    """One warm-up step and one counted step of ``run`` (a rank's step on
    the arguments ``groups``, ((name, tree), ...), whose outputs alias the
    groups named in ``aliased``), with the peak over the tracked
    arguments."""
    from torch.distributed._tools.mem_tracker import MemTracker
    t0 = time.perf_counter()
    with _alltoall_as_on_cuda(device.type):
        run()
    args = argument_leaves(groups)
    arg_bytes = sum(a["bytes"] for a in args.values())
    counter, mt = RankCounter(), MemTracker()
    mt.track_external(*[_local(x) for _, t in groups for x in T.leaves(t)
                        if isinstance(x, torch.Tensor)])
    with _alltoall_as_on_cuda(device.type), _propagation_marked(counter), \
            mt, counter, ops.tapped(counter.kernel):
        out = run()
    snap = mt.get_tracker_snapshot("peak")
    peak = max(v.get("Total", 0) for v in snap.values())
    out_bytes = rk.nbytes(*[_local(x) for x in tree_leaves(out)
                            if isinstance(x, torch.Tensor)])
    alias = sum(a["bytes"] for n, a in args.items()
                if n.split(".")[0].split("[")[0] in aliased)
    out_bytes += alias
    memory = dict(argument_bytes=arg_bytes, output_bytes=out_bytes,
                  temp_bytes=max(0, peak - arg_bytes - out_bytes + alias),
                  alias_bytes=alias, peak_per_device=int(peak),
                  arguments=args)
    return StepTrace(stats=counter.stats, n_ops=counter.n_ops,
                     kernels=counter.kernel_record(), memory=memory,
                     partition=None, trace_s=time.perf_counter() - t0,
                     device=device.type, dtype="bf16",
                     card=card_info() if device.type == "cuda" else None,
                     hlo_extra=dict(coll_by_source=counter.coll_by_source,
                                    flops_by_source=counter.flops_by_source))
