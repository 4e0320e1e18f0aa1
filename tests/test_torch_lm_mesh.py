"""The port's LM mesh path against JAX: train steps of every architecture on
4 gloo ranks (a DeviceMesh, DTensor leaves laid out by `models/sharding`)
against JAX's single-device train step, the shard shapes against JAX's
specs, the kernels' heads on each rank, a 4-rank checkpoint restored onto
the mesh and onto one device, TrainRunner's retry on a DTensor state, and
`launch.train --mesh`, and the model's layout hooks (JAX's
`with_sharding_constraint` points), each set on the 2 x 2 mesh.

The ranks run `tests/torch_mesh_ranks.py` (the port only), started by
`distributed.spawn.run`, one run per mesh shape, in a thread while this
process computes JAX's steps.  f32 on the CPU, at `reduce_arch` size; the
reduced rwkv6 takes heads of 16 (four heads, which "model" splits; the
reduced default of 64 leaves one head) in both frameworks.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm as L
import torch_mesh_ranks as R
from repro.configs import get_arch as j_get_arch
from repro.configs import reduce_arch as j_reduce_arch
from repro.models import sharding as jsharding
from repro.models.model import Model as JModel
from repro.models.rwkv import RwkvCfg as JRwkvCfg
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import get_arch, reduce_arch
from repro_torch.data.pipeline import TokenDataset
from repro_torch.distributed import spawn
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models.model import Model
from repro_torch.models.rwkv import RwkvCfg

# the tolerances of tests/test_torch_lm_train.py::test_two_train_steps_match_jax
STEP_TOL = 1e-5       # the loss, relative
MOMENT_TOL = 1e-4     # m and v, of each leaf's max
LR = 1e-2
PARAM_TOL = 0.05 * LR  # each parameter element, a step
STEPS, B, SEQ = 2, 4, 32
CLIP = 0.05            # a clip norm below every reduced model's gradient norm
# AdamW's eps in the cases of every architecture (both frameworks).  At
# the default 1e-8 an element whose gradient is near eps moves by lr * g /
# (|g| + eps), which any float32 reordering of g's sums changes by a good
# part of lr: the single-device port misses these tolerances against JAX
# at 1e-8 for gemma2-9b (parameters 1.8e-3, moments 1.2e-3) and jamba
# (moments 4.5e-4).  With eps 1e-3 the step is smooth in g.  The `clipped`
# olmo-1b case keeps the default eps, as test_two_train_steps_match_jax.
EPS = 1e-3
RWKV_HD = 16
SHAPES = {(2, 2): L.ARCHS, (1, 4): ["olmo-1b", "qwen2-moe-a2.7b"],
          (4, 1): ["olmo-1b", "qwen2-moe-a2.7b"]}
TIMEOUT_S = 600
# Each layout hook of `models/model.py`, set on the 2 x 2 mesh: (arch, the
# arch's overrides, the hooks as spec entries).  JAX's dry run sets the
# first three and the last (launch/dryrun.py:51-87); `head_sharding` (no
# JAX caller) keeps the heads whole on every rank, so WKV runs on the
# hook's placements, not the default split.  starcoder2 gets 3 heads,
# which the model axis does not divide, padded to 4 as the dry run does.
HOOKS = {
    "logits_sharding": ("olmo-1b", {}, {"logits_sharding": ("data", None, "model")}),
    "act_sharding": ("olmo-1b", {}, {"act_sharding": ("data", "model", None)}),
    "act_inner_sharding": ("olmo-1b", {}, {
        "act_sharding": ("data", "model", None),
        "act_inner_sharding": ("data", None, None)}),
    "head_sharding": ("rwkv6-3b", {}, {"head_sharding": ("data", None, None, None)}),
    "attn_head_sharding": ("starcoder2-3b", dict(n_heads=3, n_kv=1, d_model=48), {
        "pad_heads_to": 4, "attn_head_sharding": ("data", "model", None, None)}),
}
MOE_CFG = dict(n_experts=4, top_k=2, d_ff=8)
MESH_2X2 = MeshSpec((2, 2), ("data", "model"))


def arches(name: str, **kw):
    """(JAX arch, port arch), reduced, the rwkv6 heads narrowed, then
    ``kw`` replaced in both."""
    ja, ta = j_reduce_arch(j_get_arch(name)), reduce_arch(get_arch(name))
    ja, ta = dataclasses.replace(ja, **kw), dataclasses.replace(ta, **kw)
    if ta.rwkv is not None:
        ja = dataclasses.replace(ja, rwkv=JRwkvCfg(head_dim=RWKV_HD))
        ta = dataclasses.replace(ta, rwkv=RwkvCfg(head_dim=RWKV_HD))
    return ja, ta


def heads(arch) -> int:
    return arch.d_model // arch.rwkv.head_dim if arch.rwkv else arch.n_heads


def batch_of(arch, step: int) -> dict:
    """Step ``step``'s batch of `TokenDataset` (the learnable bigram stream
    of `test_two_train_steps_match_jax`), with `torch_lm.batch`'s seeded
    patch / frame embeddings for the vlm and audio front ends.  Uniform
    random labels would not do: Adam's first step moves every element by
    about lr whatever its gradient's size, so elements whose gradient is
    rounding noise differ by up to 2 lr between any two summation orders,
    the single-device port's against JAX's included."""
    ds = TokenDataset(vocab=arch.vocab, seq_len=SEQ, global_batch=B, seed=0,
                      device="cpu")
    b = {k: v.numpy().astype(np.int32) for k, v in ds.batch_at(step).items()}
    extra = L.batch(arch, B, SEQ, seed=step, labels=False)
    return dict(b, **{k: v for k, v in extra.items() if k != "tokens"})


def case_of(name: str, clip=1.0, eps=EPS, arch_kw=None, hooks=None) -> dict:
    ja, ta = arches(name, **(arch_kw or {}))
    jm = JModel(ja, dtype=jnp.float32)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return dict(arch=ta, arch_kw=arch_kw or {}, hooks=hooks or {}, params=jp,
                lr=LR, clip_norm=clip, eps=eps,
                batches=[batch_of(ta, s) for s in range(STEPS)])


def moe_hidden_of() -> dict:
    """`moe_apply`'s inputs for the `moe_hidden_sharding` case: JAX's
    decode pin (None, None, tp, "data") on the (B, T, E, F) dispatch."""
    from repro_torch.models.moe import MoeCfg
    rng = np.random.default_rng(3)
    D, E, Fd = 16, MOE_CFG["n_experts"], MOE_CFG["d_ff"]
    f32 = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
    return dict(cfg=MoeCfg(**MOE_CFG), spec=(None, None, "model", "data"),
                x=rng.standard_normal((B, 4, D)).astype(np.float32),
                params=dict(router=f32(D, E), w_gate=f32(E, D, Fd),
                            w_in=f32(E, D, Fd), w_out=f32(E, Fd, D)))


def jax_steps(c: dict) -> dict:
    """JAX's single-device train steps of a case: losses, global norms,
    params, m, v (numpy leaves in JAX's order)."""
    ja, _ = arches(c["arch"].name, **c["arch_kw"])
    jm = JModel(ja, dtype=jnp.float32)
    if "pad_heads_to" in c["hooks"]:
        jm.pad_heads_to = c["hooks"]["pad_heads_to"]
    cfg = jadamw.AdamWConfig(lr=c["lr"], clip_norm=c["clip_norm"], eps=c["eps"])

    @jax.jit
    def step(state, batch):
        params, opt = state
        loss, grads = jax.value_and_grad(jm.loss)(params, batch)
        gn = jadamw.global_norm(grads)
        params, opt = jadamw.update(grads, opt, params, cfg)
        return (params, opt), (loss, gn)

    params = jax.tree_util.tree_map(jnp.asarray, c["params"])
    state, losses, norms = (params, jadamw.init(params)), [], []
    for b in c["batches"]:
        state, (loss, gn) = step(state, L.to_jax(b))
        losses.append(float(loss))
        norms.append(float(gn))
    leaves = lambda t: [np.asarray(x) for x in jax.tree_util.tree_leaves(t)]
    return dict(losses=losses, norms=norms, params=leaves(state[0]),
                m=leaves(state[1].m), v=leaves(state[1].v))


def _run_meshes(cases: dict, ckpt_case: dict) -> dict:
    out = {}
    for shape, names in SHAPES.items():
        archs = {n: cases[n] for n in names}
        case = dict(shape=shape, archs=archs)
        if shape == (2, 2):
            case["archs"] = dict(archs, clipped=cases["clipped"],
                                 **{f"hook:{h}": cases[f"hook:{h}"] for h in HOOKS})
            case["moe_hidden"] = moe_hidden_of()
        out[shape] = spawn.run(R.train_archs, 4, timeout_s=TIMEOUT_S,
                               args=(case,))
    out["checkpoint"] = spawn.run(R.checkpoint_case, 4, timeout_s=TIMEOUT_S,
                                  args=(ckpt_case,))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The rank runs (in a thread) and JAX's steps of every case."""
    cases = {n: case_of(n) for n in L.ARCHS}
    cases["clipped"] = case_of("olmo-1b", clip=CLIP, eps=1e-8)
    for h, (name, kw, hooks) in HOOKS.items():
        cases[f"hook:{h}"] = case_of(name, arch_kw=kw, hooks=hooks)
    ck = dict(case_of("olmo-1b"), shape=(2, 2), fail_at=2,
              dir=str(tmp_path_factory.mktemp("mesh_ckpt")))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_run_meshes, cases, ck)
        # a hook changes no number: its case is held to its arch's JAX steps
        ref = {n: jax_steps(c) for n, c in cases.items()
               if not (n.startswith("hook:") and not c["arch_kw"])}
        ref.update({f"hook:{h}": ref[name] for h, (name, kw, _) in HOOKS.items()
                    if not kw})
        got = ranks.result()
    return dict(cases=cases, ref=ref, got=got, ckpt=ck)


def _leaf_err(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _hold(got: dict, ref: dict, name: str):
    for a, b in zip(got["losses"], ref["losses"]):
        assert abs(a - b) <= STEP_TOL * abs(b), (name, got["losses"], ref["losses"])
    worst = max(float(np.abs(a - b).max())
                for a, b in zip(got["params"], ref["params"]))
    assert worst <= PARAM_TOL * STEPS, (name, worst)
    for k in ("m", "v"):
        errs = [_leaf_err(a, b) for a, b in zip(got[k], ref[k])]
        assert max(errs) <= MOMENT_TOL, (name, k, max(errs))
    assert got["step"] == STEPS


def _duck_mesh(shape, names):
    """What JAX's sharding rules read of a mesh."""
    class Mesh:
        pass
    m = Mesh()
    m.axis_names = names
    m.devices = np.empty(shape)
    m.shape = dict(zip(names, shape))
    return m


def _jax_shard_shapes(name: str, shape) -> dict:
    """{leaf: its shard's shape} by JAX's `param_pspecs` with the launcher's
    tp / fsdp (launch/train.py:66-68)."""
    ja, _ = arches(name)
    jm = JModel(ja, dtype=jnp.float32)
    names = ("data", "model")[:len(shape)]
    mesh = _duck_mesh(shape, names)
    sizes = dict(zip(names, shape))
    specs = jsharding.param_pspecs(
        jm, mesh, tp="model" if "model" in names else None,
        fsdp="data" if np.prod(shape) > 1 else None)
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(jm.init_abstract())[0]
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for (path, leaf), spec in zip(flat, spec_leaves):
        entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
        div = [int(np.prod([sizes[a] for a in (e if isinstance(e, tuple) else (e,))]))
               if e is not None else 1 for e in entries]
        out[jax.tree_util.keystr(path)] = tuple(n // d for n, d in
                                               zip(leaf.shape, div))
    return out


@pytest.mark.parametrize("name", L.ARCHS)
def test_mesh_train_steps_match_jax(runs, name):
    """2 x 2 mesh: two train steps against JAX's single-device steps."""
    _hold(runs["got"][(2, 2)][0][name], runs["ref"][name], name)


@pytest.mark.parametrize("shape,name", [(s, n) for s in ((1, 4), (4, 1))
                                        for n in SHAPES[s]])
def test_mesh_shapes_train_steps_match_jax(runs, shape, name):
    _hold(runs["got"][shape][0][name], runs["ref"][name], name)


@pytest.mark.parametrize("hook", list(HOOKS))
def test_mesh_layout_hook_matches_jax(runs, hook):
    """Each layout hook set on the 2 x 2 mesh: two train steps against JAX's
    single-device steps (JAX with ``pad_heads_to`` where the case pads),
    every hook pinned at its placements, and each kernel call on the rows
    the hook's layout gives."""
    name = f"hook:{hook}"
    case = runs["cases"][name]
    _hold(runs["got"][(2, 2)][0][name], runs["ref"][name], name)
    want_pins = {repr(R.hook_of(MESH_2X2, k, v)[1])
                 for k, v in case["hooks"].items() if k != "pad_heads_to"}
    H = case["hooks"].get("pad_heads_to", heads(case["arch"]))
    split = 1 if hook == "head_sharding" else 2
    want_rows = (B // 2) * (H // split)
    for r in runs["got"][(2, 2)]:
        assert set(r[name]["pins"]) == want_pins, (r[name]["pins"], want_pins)
        rows = r[name]["rows"]
        assert rows and all(x[1] == want_rows for x in rows), (rows, want_rows)


def test_mesh_moe_hidden_sharding_hook(runs):
    """`moe_hidden_sharding` (JAX pins it in decode, which the port does
    not run on DTensors yet): `moe_apply` on the 2 x 2 mesh with and
    without the pin, output and x-gradient against the whole tensors'."""
    for r in runs["got"][(2, 2)]:
        got = r["moe_hidden"]
        scale = got["scale"]
        for tag, errs in got["errs"].items():
            assert all(e <= 1e-6 * s for e, s in zip(errs, scale)), (tag, got)
        want = repr(R.hook_of(MESH_2X2, "moe_hidden_sharding",
                              (None, None, "model", "data"))[1])
        assert got["pins"] == [want], got["pins"]


def test_mesh_clipping_active_matches_jax(runs):
    ref = runs["ref"]["clipped"]
    assert min(ref["norms"]) > CLIP, ref["norms"]
    _hold(runs["got"][(2, 2)][0]["clipped"], ref, "clipped")


@pytest.mark.parametrize("shape,name", [(s, n) for s in SHAPES
                                        for n in SHAPES[s]])
def test_mesh_local_shapes_are_jax_shards(runs, shape, name):
    want = _jax_shard_shapes(name, shape)
    for r in runs["got"][shape]:
        assert r[name]["local"] == want, (r[name]["local"], want)
        assert r[name]["local_m"] == want


@pytest.mark.parametrize("shape,name", [(s, n) for s in SHAPES
                                        for n in SHAPES[s]])
def test_mesh_kernels_see_own_heads(runs, shape, name):
    """On `plain`, every `ops.attention` / `ops.wkv6` call of a rank gets
    its batch rows times H / model heads: the cores run on shards."""
    arch = runs["cases"][name]["arch"]
    op = "wkv6" if arch.rwkv else "attention"
    want = (B // shape[0]) * (heads(arch) // shape[1])
    for r in runs["got"][shape]:
        rows = r[name]["rows"]
        assert rows and all(x == (op, want) for x in rows), (rows, want)


def test_mesh_checkpoint_restores_on_mesh_and_one_device(runs):
    got = runs["got"]["checkpoint"]
    assert all(r["restored_bitwise"] and r["placements_kept"] for r in got)
    # the same file onto one device: JAX's elastic format, the global arrays
    model = Model(runs["ckpt"]["arch"], dtype=torch.float32, device="cpu")
    tmpl = convert.lm_params_from_numpy(runs["ckpt"]["params"], device="cpu")
    from repro_torch.optim import adamw
    back = Checkpointer(runs["ckpt"]["dir"] + "/one").restore(
        (tmpl, adamw.init(tmpl)), step=1)
    assert all(t.device.type == "cpu" for t in T.leaves(back))
    saved = got[0]["saved"]
    assert len(saved) == len(T.leaves(back))
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(T.leaves(back), saved))
    del model


def test_mesh_runner_retry_restores_dtensor_state(runs):
    got = runs["got"]["checkpoint"]
    assert all(r["retries"] == 1 and r["retry_bitwise"] for r in got)


def test_launch_train_mesh_main(tmp_path):
    losses = ttrain.main(["--arch", "olmo-1b", "--reduced", "--steps", "6",
                          "--batch", "4", "--seq", "32", "--lr", "1e-2",
                          "--mesh", "2x2", "--device", "cpu",
                          "--ckpt", str(tmp_path / "c"), "--ckpt-every", "3"])
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert (tmp_path / "c" / "step_000000006").is_dir()


def test_staged_group_stages_the_all_gather():
    """The ranks' process group on a card (`distributed.staged`), its
    staged path run on the CPU: DTensor's all-gather goes through the
    host, counted with its bytes; the others pass to gloo; every result
    is the plain one.  On a CPU mesh DTensor makes its all-to-all an
    all-gather and a chunk, so two all-gathers of 32 bytes are staged."""
    got = spawn.run(R.staged_collectives, 2, timeout_s=TIMEOUT_S)
    for r in got:
        assert all(r["ok"].values()), r
        assert r["counts"] == {"all_gather_into_tensor": 2,
                               "all_gather_into_tensor bytes": 64}, r
