"""Rank side of the port's mesh tests (not a test module itself).

Each function runs in every process that `repro_torch.distributed.spawn.run`
starts (gloo on the CPU): it builds a DeviceMesh over the ranks, lays a
model's state out by JAX's rules (`launch.train.mesh_layout`,
`sharding.batch_pspecs`), runs train steps on DTensors, and returns what
the test holds against JAX: losses, the gathered parameters and moments
(rank 0), each rank's local shard shapes, and the (B*H) rows of every
`ops.attention` / `ops.wkv6` call.  It imports only the port.
"""
import contextlib
import os

import numpy as np
import torch

from repro_torch import convert
from repro_torch import tree as T
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import MeshSpec, dp_axes, make_mesh
from repro_torch.models import sharding
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import RunnerConfig, TrainRunner


@contextlib.contextmanager
def tapped(rows: list):
    """Record (op, rows of its merged (B*H, T, d) input) of every
    `ops.attention` and `ops.wkv6` call while active."""
    real = {n: getattr(ops, n) for n in ("attention", "wkv6")}

    def wrap(name):
        def fn(*a, **k):
            rows.append((name, int(a[0].shape[0])))
            return real[name](*a, **k)
        return fn
    try:
        for n in real:
            setattr(ops, n, wrap(n))
        yield rows
    finally:
        for n, f in real.items():
            setattr(ops, n, f)


# the tensor rank of each layout hook's tensor (`models/model.py`)
HOOK_NDIM = {"logits_sharding": 3, "act_sharding": 3, "act_inner_sharding": 3,
             "head_sharding": 4, "attn_head_sharding": 4,
             "moe_hidden_sharding": 4}


def hook_of(mesh, name: str, spec) -> tuple:
    """A layout hook's (DeviceMesh, placements) from JAX-style spec entries."""
    return mesh, sharding.placements(sharding.P(*spec), mesh, HOOK_NDIM[name])


@contextlib.contextmanager
def pinned(pins: list):
    """Record the placements of every `layers.pin` that redistributes (a hook
    set, a DTensor) while active, in each module that pins."""
    from repro_torch.models import layers, moe, rwkv
    real = layers.pin

    def spy(x, sharding_):
        if sharding_ is not None and layers.is_dtensor(x):
            pins.append(tuple(sharding_[1]))
        return real(x, sharding_)
    mods = (layers, moe, rwkv)
    try:
        for m in mods:
            m.pin = spy
        yield pins
    finally:
        for m in mods:
            m.pin = real


def mesh_of(shape, device: str = "cpu"):
    return make_mesh(MeshSpec(tuple(shape), ("data", "model")[:len(shape)]),
                     device)


def model_of(arch, device: str = "cpu") -> Model:
    """float32 on ``device``: the plain versions on the CPU, the kernels on
    the card."""
    return Model(arch, dtype=torch.float32, device=device,
                 backend="plain" if device == "cpu" else "auto")


def batch_on(model: Model, mesh, batch: dict) -> dict:
    """A numpy batch (every rank the same) laid out by `batch_pspecs`."""
    b = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
         .to(mesh.device_type) for k, v in batch.items()}
    B, Tn = batch["tokens"].shape
    specs = sharding.batch_pspecs(model, ShapeSpec("t", "train", Tn, B), mesh,
                                  dp=dp_axes(mesh))
    return sharding.distribute(b, {k: specs[k] for k in b}, mesh)


def state_on(model: Model, mesh, np_params: dict):
    world = int(np.prod(mesh.shape))
    params = sharding.distribute(
        convert.lm_params_from_numpy(np_params, mesh.device_type),
        ttrain.mesh_layout(model, mesh, world), mesh)
    return params, adamw.init(params)


def whole(tree_) -> list:
    """Every leaf gathered whole, as numpy (a collective)."""
    return [(t.full_tensor() if hasattr(t, "full_tensor") else t)
            .detach().cpu().numpy() for t in T.leaves(tree_)]


def local_shapes(tree_) -> dict:
    return {T.keystr(p): tuple(t.to_local().shape)
            for p, t in T.flatten_with_path(tree_)}


def train_archs(rank: int, n_ranks: int, case: dict) -> dict:
    """case: shape (the mesh), archs {name: {arch, params (JAX's, numpy),
    batches, lr, clip_norm, eps, optional hooks {model attribute: spec
    entries, or pad_heads_to's int}}}, device (default cpu), optional
    moe_hidden (`moe_hidden_case`).  Each arch's train steps on the mesh,
    with the placements of the hooks' pins."""
    device = case.get("device", "cpu")
    mesh = mesh_of(case["shape"], device)
    out = {}
    if "moe_hidden" in case:
        out["moe_hidden"] = moe_hidden_case(mesh, case["moe_hidden"])
    for name, c in case["archs"].items():
        model = model_of(c["arch"], device)
        for attr, spec in c.get("hooks", {}).items():
            setattr(model, attr, spec if attr == "pad_heads_to" else
                    hook_of(mesh, attr, spec))
        state = state_on(model, mesh, c["params"])
        step = ttrain.make_train_step(model, adamw.AdamWConfig(
            lr=c["lr"], clip_norm=c["clip_norm"], eps=c["eps"]))
        rows, losses, pins = [], [], []
        with tapped(rows), pinned(pins):
            for b in c["batches"]:
                batch = batch_on(model, mesh, b)
                state, loss = step(state, batch)
                losses.append(float(loss))
        params, opt = state
        got = dict(losses=losses, rows=rows, local=local_shapes(params),
                   local_m=local_shapes(opt.m), step=int(opt.step),
                   pins=sorted(set(map(repr, pins))))
        gathered = dict(params=whole(params), m=whole(opt.m), v=whole(opt.v))
        if rank == 0:
            got.update(gathered)
        out[name] = got
    return out


def moe_hidden_case(mesh, case: dict) -> dict:
    """`moe.moe_apply` on ``case``'s numpy x (B, T, D) and expert weights
    (float32): on whole tensors, and on DTensors (x's rows over "data", the
    experts over "model", as `param_pspecs` lays them) without and with
    ``hidden_sharding`` at ``case["spec"]`` (JAX's decode pin).  Returns
    each mesh output's and x-gradient's largest difference from the whole
    tensors' (gathered) and the pins' placements."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import moe
    cfg = case["cfg"]
    p = {k: torch.from_numpy(v) for k, v in case["params"].items()}
    x = torch.from_numpy(case["x"]).requires_grad_()
    out, _ = moe.moe_apply(p, x, cfg)
    gx, = torch.autograd.grad(out.square().sum(), x)
    dims = mesh.mesh_dim_names
    pd = {k: distribute_tensor(v, mesh, [
        Shard(0) if n == "model" and v.dim() == 3 else Replicate()
        for n in dims]) for k, v in p.items()}
    errs, pins = {}, []
    for tag, hs in (("plain", None),
                    ("pinned", hook_of(mesh, "moe_hidden_sharding",
                                       case["spec"]))):
        xd = distribute_tensor(x.detach(), mesh, [
            Shard(0) if n == "data" else Replicate() for n in dims])
        xd.requires_grad_()
        with pinned(pins):
            od, _ = moe.moe_apply(pd, xd, cfg, hidden_sharding=hs)
        gd, = torch.autograd.grad(od.square().sum(), xd)
        errs[tag] = (float((od.full_tensor() - out).abs().max()),
                     float((gd.full_tensor() - gx).abs().max()))
    return dict(errs=errs, scale=(float(out.abs().max()),
                                  float(gx.abs().max())),
                pins=sorted(set(map(repr, pins))))


def checkpoint_case(rank: int, n_ranks: int, case: dict) -> dict:
    """One step of ``case["arch"]`` on the mesh, saved to ``case["dir"]``
    (rank 0 writes); restored onto the mesh from a fresh layout, which must
    equal the saved state bitwise; then TrainRunner with a failure at
    ``case["fail_at"]`` (every rank), which restores the checkpoint and
    retries, against a run without the failure."""
    mesh = mesh_of(case["shape"])
    model = model_of(case["arch"])
    state = state_on(model, mesh, case["params"])
    step = ttrain.make_train_step(model, adamw.AdamWConfig(lr=case["lr"]))
    batches = [batch_on(model, mesh, b) for b in case["batches"]]
    state1, _ = step(state, batches[0])
    ck = Checkpointer(os.path.join(case["dir"], "one"))
    ck.save(1, state1, blocking=True)
    back = ck.restore(state_on(model, mesh, case["params"]), step=1)
    same = all(np.array_equal(a, b) for a, b in zip(whole(back), whole(state1)))
    same_placements = all(
        a.placements == b.placements
        for a, b in zip(T.leaves(back), T.leaves(state1))
        if hasattr(a, "placements"))

    class Batches:
        def batch_at(self, s):
            return batches[s % len(batches)]

    def run(fail_at, sub):
        failed = []

        def step_fn(st, batch):
            if len(failed) == 0 and fail_at is not None and \
                    int(st[1].step) == fail_at:
                failed.append(fail_at)
                raise FloatingPointError("injected failure")
            st, loss = step(st, batch)
            return st, {"loss": loss}
        runner = TrainRunner(step_fn, Batches(), RunnerConfig(
            checkpoint_dir=os.path.join(case["dir"], sub), checkpoint_every=2,
            backoff_base_s=0.0, emit_metrics=False))
        final = runner.run(state_on(model, mesh, case["params"]), n_steps=4)
        return whole(final), runner.stats
    saved = whole(state1)
    clean, _ = run(None, "clean")
    retried, stats = run(case["fail_at"], "retry")
    return dict(restored_bitwise=same, placements_kept=same_placements,
                saved=saved if rank == 0 else None,
                retry_bitwise=all(np.array_equal(a, b)
                                  for a, b in zip(clean, retried)),
                retries=stats["retries"])


def staged_collectives(rank: int, n_ranks: int) -> dict:
    """DTensor's four redistributions on a 1-D mesh over a `gloostaged`
    group whose every tensor counts as on a card (so the staged path runs
    on the CPU): each result against the plain value, and the staged calls
    the group counted."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.distributed import staged
    staged.register()
    staged._on_card = lambda *ts: True
    group = dist.new_group(list(range(n_ranks)), backend=staged.NAME)
    mesh = DeviceMesh.from_group(group, "cpu")
    full = torch.arange(16.0).reshape(4, 4)
    rows = full.chunk(n_ranks)[rank]
    ok = {}
    staged.reset_counts()
    d = DTensor.from_local(rows, mesh, [Shard(0)])
    ok["all_gather"] = torch.equal(d.redistribute(mesh, [Replicate()])
                                   .to_local(), full)
    ok["all_to_all"] = torch.equal(
        d.redistribute(mesh, [Shard(1)]).to_local(),
        full.chunk(n_ranks, dim=1)[rank])
    p = DTensor.from_local(full * (rank + 1), mesh, [Partial()])
    total = full * sum(range(1, n_ranks + 1))
    ok["reduce_scatter"] = torch.equal(p.redistribute(mesh, [Shard(0)])
                                       .to_local(), total.chunk(n_ranks)[rank])
    ok["all_reduce"] = torch.equal(p.redistribute(mesh, [Replicate()])
                                   .to_local(), total)
    return dict(ok=ok, counts=dict(staged.COUNTS))


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_gpu.py)
# ---------------------------------------------------------------------------
def gloo_cuda_probe(rank: int, n_ranks: int) -> dict:
    """The four collectives DTensor issues, called on plain gloo with CUDA
    tensors: {op: "ok" or the error}, each result against its value."""
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    x = torch.arange(8.0, device=dev) + rank
    full = torch.cat([torch.arange(8.0) + r for r in range(n_ranks)])
    total = sum(torch.arange(8.0) + r for r in range(n_ranks))
    out = {}

    def attempt(name, fn, want):
        try:
            got = fn()
            torch.cuda.synchronize()
            out[name] = "ok" if torch.equal(got.cpu(), want) else f"wrong {got}"
        except RuntimeError as e:
            out[name] = f"refused: {e}"[:300]

    def ag():
        o = torch.empty(8 * n_ranks, device=dev)
        dist.all_gather_into_tensor(o, x)
        return o

    def rs():
        o = torch.empty(8 // n_ranks, device=dev)
        dist.reduce_scatter_tensor(o, x.clone())
        return o

    def ar():
        o = x.clone()
        dist.all_reduce(o)
        return o

    def a2a():
        o = torch.empty(8, device=dev)
        dist.all_to_all_single(o, x.clone())
        return o
    chunk = 8 // n_ranks
    attempt("all_gather_into_tensor", ag, full)
    attempt("reduce_scatter_tensor", rs, total[rank * chunk:(rank + 1) * chunk])
    attempt("all_reduce", ar, total)
    attempt("all_to_all_single", a2a, torch.cat(
        [(torch.arange(8.0) + r)[rank * chunk:(rank + 1) * chunk]
         for r in range(n_ranks)]))
    return out


def dtensor_all_gather_cuda(rank: int, n_ranks: int) -> bool:
    """DTensor's Shard -> Replicate on a CUDA mesh over the group the rank
    runs on: True when the gathered tensor is right."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.distributed import staged
    mesh = DeviceMesh("cuda", list(range(n_ranks)))
    full = torch.arange(16.0, device="cuda").reshape(4, 4)
    d = DTensor.from_local(full.chunk(n_ranks)[rank].contiguous(), mesh,
                           [Shard(0)])
    staged.reset_counts()
    ok = torch.equal(d.redistribute(mesh, [Replicate()]).to_local(), full)
    return dict(ok=ok, counts=dict(staged.COUNTS))


def gpu_mesh_step(rank: int, n_ranks: int, case: dict) -> dict:
    """``case["steps"]`` (default 1) train steps of ``case["arch"]``
    (float32, seeded on the card) on a ``case["shape"]`` mesh of ranks that
    share the card: the first loss and every loss, the gathered parameters
    and moments (rank 0), the rank's kernel launches over the steps and the
    rows each kernel call saw, and the staged collectives."""
    from repro_torch.distributed import staged
    mesh = make_mesh(MeshSpec(tuple(case["shape"]), ("data", "model")),
                     "cuda")
    model = Model(case["arch"], dtype=torch.float32, device="cuda")
    params = sharding.distribute(model.init(0), ttrain.mesh_layout(
        model, mesh, n_ranks), mesh)
    state = (params, adamw.init(params))
    batch = batch_on(model, mesh, case["batch"])
    step = ttrain.make_train_step(model, adamw.AdamWConfig(lr=case["lr"],
                                                           eps=case["eps"]))
    ops.reset_launches()
    staged.reset_counts()
    rows, losses = [], []
    with tapped(rows):
        for _ in range(case.get("steps", 1)):
            state, loss = step(state, batch)
            losses.append(float(loss))
    torch.cuda.synchronize()
    launches = {f"{k[0]}/{k[1]}": v for k, v in ops.LAUNCHES.items()}
    gathered = dict(params=whole(state[0]), m=whole(state[1].m),
                    v=whole(state[1].v))
    on_card = all(t.to_local().is_cuda for t in T.leaves(state[0]))
    out = dict(loss=losses[0], losses=losses, launches=launches, rows=rows,
               staged=dict(staged.COUNTS), on_card=on_card, params=None)
    if rank == 0:
        out.update(gathered)
    return out


def serve_archs(rank: int, n_ranks: int, case: dict) -> dict:
    """case: shape (the mesh), archs {name: {arch, B, optional prompt (the
    prefill's tokens, numpy (B, T)), steps (decode tokens, numpy (n, B,
    1)), max_len}}.  Each arch's `Model.prefill` and `decode_step` (from an
    empty cache, one step a token) on the mesh: seeded float32 parameters
    laid out by JAX's rules, the batch and the cache by `batch_pspecs`, the
    hooks set as the dry run sets them (`lm_dryrun.set_hooks`); and the same
    on one device.  Returns each one's largest difference over max |ref|:
    the prefill's logits, each decode step's, and the cache after the last
    step, with the cache's local shapes."""
    from repro_torch.launch import lm_dryrun
    mesh = mesh_of(case["shape"])
    out = {"zero1": zero1_update(mesh)}
    for name, c in case["archs"].items():
        arch, B = c["arch"], c["B"]
        one, dist_model = model_of(arch), model_of(arch)
        params = one.init(0)
        errs = {}
        kinds = ((("prefill", c["prompt"].shape[1]),) if "prompt" in c
                 else ()) + (("decode", c["max_len"]),)
        for kind, T_ in kinds:
            shape = ShapeSpec(kind, kind, T_, B)
            tp, dp = sharding.strategy_for(arch, mesh, B)
            lm_dryrun.set_hooks(dist_model, shape, mesh, tp, dp)
            dparams = sharding.distribute(
                params, sharding.param_pspecs(dist_model, mesh, tp=tp), mesh)
            specs = sharding.batch_pspecs(dist_model, shape, mesh, dp=dp,
                                          tp=tp or "model")
            if kind == "prefill":
                tokens = torch.from_numpy(c["prompt"].astype(np.int64))
                ref = one.prefill(params, {"tokens": tokens})
                got = dist_model.prefill(dparams, sharding.distribute(
                    {"tokens": tokens}, {"tokens": specs["tokens"]}, mesh))
                errs["prefill"] = _share(got.full_tensor(), ref)
                continue
            cache = one.init_cache(B, c["max_len"])
            dcache = sharding.distribute(one.init_cache(B, c["max_len"]),
                                         specs["cache"], mesh)
            steps = []
            for pos, tok in enumerate(c["steps"]):
                tok = torch.from_numpy(tok.astype(np.int64))
                ref, cache = one.decode_step(params, cache, tok, pos)
                dtok = sharding.distribute({"t": tok}, {"t": specs["tokens"]},
                                           mesh)["t"]
                got, dcache = dist_model.decode_step(dparams, dcache, dtok, pos)
                steps.append(_share(got.full_tensor(), ref))
            errs["decode"] = max(steps)
            errs["cache"] = max(_share(d.full_tensor(), r) for d, r in zip(
                T.leaves(dcache), T.leaves(cache)))
            errs["cache_local"] = local_shapes(dcache)
        out[name] = errs
    return out


def zero1_update(mesh) -> dict:
    """One `adamw.update` of an (8, 6) leaf whose moments are split
    further than the parameter (ZeRO-1: the parameter [Replicate(),
    Shard(1)], m and v [Shard(0), Shard(1)]), out of place and in place,
    against one device: the largest difference of the new parameter and
    moments, and the new parameter's placements."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    g = torch.Generator().manual_seed(0)
    p, grad = (torch.randn(8, 6, generator=g) for _ in range(2))
    st = adamw.init({"w": p.clone()})
    ref_p, ref_st = adamw.update({"w": grad}, st, {"w": p.clone()})
    p_pl, m_pl = (Replicate(), Shard(1)), (Shard(0), Shard(1))
    out = {}
    for inplace in (False, True):
        d = lambda t, pl: distribute_tensor(t.clone(), mesh, pl)
        dst = adamw.AdamWState(m={"w": d(torch.zeros(8, 6), m_pl)},
                               v={"w": d(torch.zeros(8, 6), m_pl)},
                               step=torch.zeros((), dtype=torch.int32))
        new_p, new_st = adamw.update({"w": d(grad, p_pl)}, dst,
                                     {"w": d(p, p_pl)}, inplace=inplace)
        out[inplace] = dict(
            err=max(float((a.full_tensor() - b).abs().max()) for a, b in (
                (new_p["w"], ref_p["w"]), (new_st.m["w"], ref_st.m["w"]),
                (new_st.v["w"], ref_st.v["w"]))),
            placements=repr(tuple(new_p["w"].placements)))
    return out


def vocab_parallel(rank: int, n_ranks: int) -> dict:
    """`layers.token_nll` on float32 logits (B, T, V) at JAX's
    `logits_sharding` on a 2 x 2 mesh (rows over "data", V over "model")
    and `layers.embed_lookup` on a table (V, D) at its spec (V over
    "model", D over "data"), each against one device: the largest
    difference over max |ref| of the values and of the gradients (a seeded
    upstream gradient), and the lookup's output placements."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import layers
    mesh = mesh_of((2, 2))
    g = torch.Generator().manual_seed(0)
    B, T, V, D = 4, 6, 10, 8
    lf = torch.randn(B, T, V, generator=g) * 4
    labels = torch.randint(0, V, (B, T), generator=g)
    table = torch.randn(V, D, generator=g)
    tokens = torch.randint(0, V, (B, T), generator=g)
    up_nll, up_emb = torch.randn(B, T, generator=g), torch.randn(B, T, D,
                                                                 generator=g)
    rows = [Shard(0), Replicate()]
    errs = {}
    for name, fn, x, ints, up, x_pl in (
            ("token_nll", layers.token_nll, lf, labels, up_nll,
             [Shard(0), Shard(2)]),
            ("embed_lookup", lambda t, i: layers.embed_lookup(t, i), table,
             tokens, up_emb, [Shard(1), Shard(0)])):
        x = x.clone().requires_grad_()
        ref = fn(x, ints)
        gref, = torch.autograd.grad((ref * up).sum(), x)
        dx = distribute_tensor(x.detach(), mesh, x_pl).requires_grad_()
        out = fn(dx, distribute_tensor(ints, mesh, rows))
        if name == "embed_lookup":
            errs["placements"] = repr(tuple(out.placements))
        dup = distribute_tensor(up, mesh, rows)
        gd, = torch.autograd.grad((out * dup).sum(), dx)
        errs[name] = _share(out.full_tensor(), ref)
        errs[name + " grad"] = _share(gd.full_tensor(), gref)
    return dict(placements=errs.pop("placements"), errs=errs)


def _share(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).abs().max() / max(float(ref.abs().max()), 1e-30))
