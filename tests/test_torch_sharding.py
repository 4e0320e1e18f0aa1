"""The port's sharding rules (`models/sharding.py`, `launch/mesh.py`)
against JAX's, leaf for leaf, for every architecture at full size on the
production meshes (16, 16) and (2, 16, 16) and the test mesh (2, 4); the
DTensor placements' local shapes against JAX's shard shapes; and
`pad_heads_to` against JAX and against no padding.

JAX's rules read only a mesh's `axis_names`, `devices.shape` and `shape`,
so they get a duck-typed mesh; JAX's shard shapes come from a
`NamedSharding` on an `AbstractMesh`; DTensor's local shapes from a
`DeviceMesh` on the ``fake`` process group (no communication, one
process), set up and torn down by the module's fixture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

import torch_lm as L
from repro.configs import SHAPES as J_SHAPES
from repro.configs import applicable_shapes as j_applicable_shapes
from repro.configs import get_arch as j_get_arch
from repro.configs import reduce_arch as j_reduce_arch
from repro.launch import mesh as jmesh_mod
from repro.models import sharding as jsharding
from repro.models.model import Model as JModel
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import SHAPES, applicable_shapes, get_arch, reduce_arch
from repro_torch.launch import mesh as tmesh
from repro_torch.models import sharding
from repro_torch.models.model import Model, value_and_grad

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 4): ("data", "model")}
GRAD_TOL = 1e-4     # tests/test_torch_lm_train.py's


class DuckMesh:
    """What JAX's sharding rules read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)
        self.shape = dict(zip(names, shape))


@pytest.fixture(scope="module")
def models():
    """{name: (JAX model, port model)} at full size."""
    return {n: (JModel(j_get_arch(n), dtype=jnp.bfloat16),
                Model(get_arch(n), dtype=torch.bfloat16, device="cpu"))
            for n in L.ARCHS}


@pytest.fixture(scope="module")
def abstract(models):
    """JAX's abstract parameter trees (traced once per arch)."""
    return {n: jm.init_abstract() for n, (jm, _) in models.items()}


def _jleaves(tree_):
    return jax.tree_util.tree_leaves(tree_, is_leaf=lambda x: isinstance(x, JP))


def _same(jspecs, tspecs):
    """Leaf for leaf: the same entries in the same order of leaves."""
    j = [tuple(s) for s in _jleaves(jspecs)]
    t = [tuple(s) for s in T.leaves(tspecs)]
    assert len(j) == len(t)
    bad = [(i, a, b) for i, (a, b) in enumerate(zip(j, t)) if a != b]
    assert not bad, bad[:5]
    assert all(isinstance(s, sharding.PartitionSpec) for s in T.leaves(tspecs))


def test_mesh_specs_and_axes():
    for multi in (False, True):
        spec = tmesh.production_spec(multi_pod=multi)
        shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi else \
            ((16, 16), ("data", "model"))
        assert (spec.sizes, spec.axis_names) == (shape, names)
        duck = DuckMesh(shape, names)
        assert tmesh.dp_axes(spec) == jmesh_mod.dp_axes(duck)
    assert tmesh.small_spec().sizes == (2, 4)
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_test_mesh(device_type="cpu")


@pytest.mark.parametrize("name", L.ARCHS)
def test_strategy_for_matches_jax(name, monkeypatch):
    for ssm_tp in ("0", "1"):
        monkeypatch.setenv("REPRO_SSM_TP", ssm_tp)
        for shape, names in MESHES.items():
            duck, spec = DuckMesh(shape, names), tmesh.MeshSpec(shape, names)
            for s in applicable_shapes(get_arch(name)):
                gb = SHAPES[s].global_batch
                assert sharding.strategy_for(get_arch(name), spec, gb) == \
                    jsharding.strategy_for(j_get_arch(name), duck, gb), (s, shape)


@pytest.mark.parametrize("name", L.ARCHS)
def test_param_and_opt_pspecs_match_jax(name, models, abstract, monkeypatch):
    jm, tm = models[name]
    monkeypatch.setattr(jm, "init_abstract", lambda: abstract[name])
    for shape, names in MESHES.items():
        duck, spec = DuckMesh(shape, names), tmesh.MeshSpec(shape, names)
        for tp in ("model", None):
            for fsdp in ("data", None):
                jp = jsharding.param_pspecs(jm, duck, tp=tp, fsdp=fsdp)
                tp_ = sharding.param_pspecs(tm, spec, tp=tp, fsdp=fsdp)
                _same(jp, tp_)
                for zero1 in (True, False):
                    _same(jsharding.opt_pspecs(jp, abstract[name], duck, zero1),
                          sharding.opt_pspecs(tp_, tm.init_abstract(), spec,
                                              zero1))


@pytest.mark.parametrize("name", L.ARCHS)
def test_batch_pspecs_match_jax(name, models):
    jm, tm = models[name]
    for shape, names in MESHES.items():
        duck, spec = DuckMesh(shape, names), tmesh.MeshSpec(shape, names)
        for s in j_applicable_shapes(j_get_arch(name)):
            dp = jmesh_mod.dp_axes(duck)
            assert tmesh.dp_axes(spec) == dp
            _same(jsharding.batch_pspecs(jm, J_SHAPES[s], duck, dp=dp),
                  sharding.batch_pspecs(tm, SHAPES[s], spec, dp=dp))


# ---------------------------------------------------------------------------
# placements: DTensor's local shapes against JAX's shard shapes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fake_meshes():
    """DeviceMeshes of MESHES on the ``fake`` process group (rank 0 of
    512); the group is destroyed after the module's tests."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import DeviceMesh
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        yield {shape: DeviceMesh("cpu", torch.arange(int(np.prod(shape)))
                                 .reshape(shape), mesh_dim_names=names)
               for shape, names in MESHES.items()}
    finally:
        dist.destroy_process_group()


def _local_shape(global_shape, mesh, placements):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return tuple(compute_local_shape_and_global_offset(
        global_shape, mesh, placements)[0])


def _check_local_shapes(jspecs, tspecs, shapes, mesh, names, sizes):
    amesh = AbstractMesh(sizes, names)
    for js, ts, shp in zip(_jleaves(jspecs), T.leaves(tspecs), shapes):
        want = NamedSharding(amesh, js).shard_shape(tuple(shp))
        got = _local_shape(tuple(shp), mesh,
                           sharding.placements(ts, mesh, len(shp)))
        assert got == want, (js, ts, shp, got, want)


@pytest.mark.parametrize("name", L.ARCHS)
def test_placements_give_jax_shard_shapes(name, models, abstract, fake_meshes,
                                          monkeypatch):
    jm, tm = models[name]
    monkeypatch.setattr(jm, "init_abstract", lambda: abstract[name])
    shapes = [t.shape for t in T.leaves(tm.init_abstract())]
    for shape, names in MESHES.items():
        duck, spec = DuckMesh(shape, names), tmesh.MeshSpec(shape, names)
        mesh = fake_meshes[shape]
        jp = jsharding.param_pspecs(jm, duck, tp="model", fsdp="data")
        tp_ = sharding.param_pspecs(tm, spec, tp="model", fsdp="data")
        _check_local_shapes(jp, tp_, shapes, mesh, names, shape)
        _check_local_shapes(jsharding.opt_pspecs(jp, abstract[name], duck),
                            sharding.opt_pspecs(tp_, tm.init_abstract(), spec),
                            shapes, mesh, names, shape)
        # the batch and the decode caches: tuple axes (("pod", "data"), the
        # long-context sequence over ("data", "model")) and the fallbacks
        for s in applicable_shapes(get_arch(name)):
            dp = tmesh.dp_axes(spec)
            jb = jsharding.batch_pspecs(jm, J_SHAPES[s], duck, dp=dp)
            tb = sharding.batch_pspecs(tm, SHAPES[s], spec, dp=dp)
            inputs = tm.input_specs(SHAPES[s])
            _check_local_shapes(jb, tb, [t.shape for t in T.leaves(inputs)],
                                mesh, names, shape)


def test_placements_of_tuple_axes_and_order(fake_meshes):
    from torch.distributed.tensor import Replicate, Shard
    mesh = fake_meshes[(2, 16, 16)]
    assert sharding.placements(sharding.P(("pod", "data"), None), mesh, 2) == \
        (Shard(0), Shard(0), Replicate())
    assert sharding.placements(sharding.P(None, ("data", "model")), mesh, 3) == \
        (Replicate(), Shard(1), Shard(1))
    with pytest.raises(ValueError, match="order"):
        sharding.placements(sharding.P(("model", "data")), mesh, 1)
    with pytest.raises(ValueError, match="twice"):
        sharding.placements(sharding.P("data", "data"), mesh, 2)


# ---------------------------------------------------------------------------
# pad_heads_to
# ---------------------------------------------------------------------------
def _starcoder_3_heads():
    """Reduced starcoder2 with 3 heads (which no even model axis divides)."""
    kw = dict(n_heads=3, n_kv=1, d_model=48)
    return (dataclasses.replace(j_reduce_arch(j_get_arch("starcoder2-3b")), **kw),
            dataclasses.replace(reduce_arch(get_arch("starcoder2-3b")), **kw))


def test_pad_heads_to_matches_jax_and_no_padding():
    ja, ta = _starcoder_3_heads()
    jm = JModel(ja, dtype=jnp.float32)
    jm.pad_heads_to = 4
    jp = jm.init(jax.random.PRNGKey(0))
    b = L.batch(ta, 2, 32, seed=1)
    j_loss, j_grads = jax.jit(jax.value_and_grad(jm.loss))(jp, L.to_jax(b))
    tp = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")
    got = {}
    for pad in (4, None):
        tm = Model(ta, dtype=torch.float32, device="cpu", backend="plain")
        tm.pad_heads_to = pad
        got[pad] = value_and_grad(tm.loss, tp, L.to_torch(b))
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(j_grads)]
    for loss, grads in got.values():
        assert abs(float(loss) - float(j_loss)) <= GRAD_TOL * abs(float(j_loss))
        for g, j in zip(T.leaves(grads), jl):
            assert L.rel_err(g, j) <= GRAD_TOL
    for a, b_ in zip(T.leaves(got[4][1]), T.leaves(got[None][1])):
        assert L.rel_err(a, b_) <= GRAD_TOL
