"""The port's distributed runtime against the JAX package's, in one process:
the partition (`repro_torch.distributed.partition`) array for array, JAX's
four numpy invariants on it, the halo exchange's chaos site, the backend
a rank dispatches, the one-rank step, field forcing, and the ocean cells.

The multi-rank steps run in `tests/test_torch_distributed_ranks.py` (per
stage) and `tests/test_torch_distributed_ca.py` (comm-avoiding).
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import mesh2d as jmesh  # noqa: E402
from repro.distributed import partition as jpart  # noqa: E402
from repro_torch.core import geometry, mesh2d, stepper  # noqa: E402
from repro_torch.core.extrusion import VGrid  # noqa: E402
from repro_torch.distributed import halo, ocean, partition  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import ocean_dryrun  # noqa: E402
from repro_torch.runtime import chaos  # noqa: E402

MESHES = {
    "square": dict(nx=16, ny=16, jitter=0.2, seed=1),                # nt 512
    "jax_case": dict(nx=16, ny=8, lx=4000.0, ly=2000.0, jitter=0.2,  # nt 256
                     seed=4),
}


@pytest.fixture(scope="module")
def meshes():
    return {k: (mesh2d.rect_mesh(**kw), jmesh.rect_mesh(**kw))
            for k, kw in MESHES.items()}


@pytest.mark.parametrize("depth", [1, 2, 6])
@pytest.mark.parametrize("n_parts", [2, 4, 8])
@pytest.mark.parametrize("name", list(MESHES))
def test_partition_equals_jax(meshes, name, n_parts, depth):
    m, jm = meshes[name]
    np.testing.assert_array_equal(m.tri, jm.tri)
    a = partition.build_partition(m, n_parts, depth)
    b = jpart.build_partition(jm, n_parts, depth)
    assert (a.n_parts, a.n_own, a.n_loc) == (b.n_parts, b.n_own, b.n_loc)
    for f in ("neigh_tri", "neigh_edge", "edge_type", "glob_ids",
              "owned_mask"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert sorted(a.tables) == sorted(b.tables)
    for off in a.tables:
        for i in range(2):
            np.testing.assert_array_equal(a.tables[off][i], b.tables[off][i])
    # one rank's own pieces: its local mesh and its rows of the tables
    rank = n_parts - 1
    lm, jlm = (partition.local_mesh(m, a, rank),
               jpart.local_meshes(jm, b)[rank])
    for f in ("tri", "neigh_tri", "neigh_edge", "edge_type"):
        np.testing.assert_array_equal(getattr(lm, f), getattr(jlm, f))
    t = halo.tables_from_spec(a, rank)
    assert t.offsets == tuple(sorted(a.tables)) and t.n_parts == n_parts
    for off, s, r in zip(t.offsets, t.send, t.recv):
        np.testing.assert_array_equal(s.numpy(), a.tables[off][0][rank])
        np.testing.assert_array_equal(r.numpy(), a.tables[off][1][rank])


# ---------------------------------------------------------------------------
# the JAX package's numpy invariants (tests/test_distributed.py), on the port
# ---------------------------------------------------------------------------
def _square():
    return mesh2d.rect_mesh(16, 16, 1.0, 1.0, jitter=0.2, seed=1)


def test_partition_covers_mesh():
    m = _square()
    spec = partition.build_partition(m, 8, halo_depth=1)
    ids = spec.glob_ids[:, :spec.n_own].ravel()
    assert sorted(ids.tolist()) == list(range(m.nt))


def test_partition_halo_contains_all_neighbours():
    m = _square()
    spec = partition.build_partition(m, 8, halo_depth=1)
    for p in range(8):
        own = set(range(p * spec.n_own, (p + 1) * spec.n_own))
        local = set(spec.glob_ids[p].tolist())
        for t in own:
            for n in m.neigh_tri[t]:
                assert int(n) in local, (p, t, n)


def test_partition_exchange_tables_consistent():
    """Sending p's owned slot for triangle t must land in the receiver's
    halo slot for the same global triangle."""
    m = _square()
    spec = partition.build_partition(m, 8, halo_depth=2)
    trash = spec.n_loc - 1
    for off, (send, recv) in spec.tables.items():
        for src in range(8):
            dst = (src + off) % 8
            for j in range(send.shape[1]):
                r = recv[dst, j]
                if r == trash:
                    continue
                assert (spec.glob_ids[src, send[src, j]]
                        == spec.glob_ids[dst, r]), (off, src, j)


def test_scatter_gather_roundtrip():
    m = _square()
    spec = partition.build_partition(m, 8, halo_depth=1)
    f = np.random.default_rng(0).normal(size=(3, m.nt))
    back = partition.gather_field(spec, partition.scatter_field(spec, f))
    np.testing.assert_array_equal(back, f)


# ---------------------------------------------------------------------------
# halo exchange: the payload chaos site (tests/test_chaos.py's, one rank)
# ---------------------------------------------------------------------------
def test_halo_payload_chaos_site():
    t = halo.HaloTables(send=(torch.arange(2),), recv=(torch.tensor([2, 3]),),
                        offsets=(0,), n_parts=1)
    tr = halo.Transport()
    assert tr.mode == "local"
    x = torch.arange(1.0, 5.0)
    clean = halo.exchange(x, t, tr)
    np.testing.assert_array_equal(clean.numpy(), [1.0, 2.0, 1.0, 2.0])

    plan = chaos.FaultPlan([chaos.Fault("halo.payload", "halo_nan")])
    with chaos.active(plan):
        poisoned = halo.exchange(x * 1.0, t, tr)
    assert torch.isnan(poisoned[2:]).all()                 # halo slots
    np.testing.assert_array_equal(poisoned[:2].numpy(), [1.0, 2.0])
    assert plan.log[0]["kind"] == "halo_nan"
    np.testing.assert_array_equal(x.numpy(), [1.0, 2.0, 3.0, 4.0])
    # stacked fields: one shift for all of them; a tree: each leaf
    a, b = halo.exchange_batch([x, 10 * x], t, tr)
    np.testing.assert_array_equal(b.numpy(), [10.0, 20.0, 10.0, 20.0])
    tree = halo.exchange_tree({"u": x, "v": (x + 1,)}, t, tr)
    np.testing.assert_array_equal(tree["v"][0].numpy(), [2.0, 3.0, 2.0, 3.0])


# ---------------------------------------------------------------------------
# one rank, no process group
# ---------------------------------------------------------------------------
def _small():
    m = mesh2d.rect_mesh(4, 3, 2000.0, 1500.0, jitter=0.2, seed=3)
    return m, np.full((3, m.nt), 20.0)


@pytest.mark.parametrize("backend,runs", [("plain", "plain"),
                                          ("cuda", None), ("ref", "ref"),
                                          ("auto", "plain")])
def test_backend_is_the_configured_one(backend, runs):
    """Unlike JAX's DistributedOcean, which pins its shard_map step to ref
    with a warning, a rank's local step dispatches as the single-device
    step does: `auto` is the plain versions on CPU tensors (the kernels on
    the card), and `cuda` on CPU tensors raises."""
    m, b = _small()
    cfg = stepper.OceanConfig(nl=3, dt=20.0, m_2d=4, backend=backend)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        do = ocean.DistributedOcean(m, b, cfg, 0, 1, halo.Transport(),
                                    device="cpu")
    assert do.cfg.backend == backend
    step, st = do.make_step(), do.init_state()
    ops.reset_launches()
    if runs is None:
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            step(st)
        return
    step(st)
    assert {bk for _, bk in ops.LAUNCHES} == {runs}


def test_one_rank_is_the_single_device_step():
    """One rank (no process group, no halo, one trash slot): the owned
    slots step bitwise as the single-device ref step."""
    m, b = _small()
    cfg = stepper.OceanConfig(nl=3, dt=20.0, m_2d=4, use_gls=True,
                              backend="ref")
    geom = geometry.geom2d_from_mesh(m, dtype=torch.float64, device="cpu")
    vg = VGrid(b=torch.as_tensor(b), nl=3)
    st = stepper.init_state(geom, vg)
    st = dataclasses.replace(st, ext=dataclasses.replace(
        st.ext, eta=0.05 * torch.cos(torch.pi * geom.node_x / 2000.0)))
    do = ocean.DistributedOcean(m, b, cfg, 0, 1, halo.Transport(),
                                device="cpu")
    assert (do.spec.n_loc, do.tables.offsets) == (m.nt + 1, ())
    step = do.make_step()
    loc, ref = do.scatter_state(st), st
    for _ in range(2):
        loc, ref = step(loc), stepper.step(geom, vg, cfg, ref)
    out = do.gather_state(loc)
    for k in ("ux", "uy", "T", "S", "turb_k", "turb_eps", "nu_t", "kappa_t"):
        assert torch.equal(getattr(out, k), getattr(ref, k)), k
    assert torch.equal(out.ext.eta, ref.ext.eta)
    assert float(out.ux.abs().max()) > 1e-6


def test_field_forcing_is_rejected_as_in_jax():
    """Both frameworks pass the global forcing unchanged into the local
    step, so a (3, nt) wind stress meets (3, n_loc) local fields and the
    step fails, in JAX (one device) as in the port (one rank)."""
    from jax.sharding import Mesh
    from repro.core import geometry as jgeo
    from repro.core import stepper as jstep
    from repro.core.extrusion import VGrid as JVGrid
    from repro.distributed.ocean import DistributedOcean as JDO

    m, b = _small()
    tau = np.full((3, m.nt), 1e-4)
    jcfg = jstep.OceanConfig(nl=3, dt=20.0, m_2d=4)
    jm = jmesh.rect_mesh(4, 3, 2000.0, 1500.0, jitter=0.2, seed=3)
    jdo = JDO(jm, b, jcfg, Mesh(np.array(jax.devices()[:1]), ("x",)), ("x",),
              dtype=jnp.float64)
    jgeom = jgeo.geom2d_from_mesh(jm, dtype=jnp.float64)
    jst = jdo.scatter_state(jstep.init_state(
        jgeom, JVGrid(b=jnp.asarray(b), nl=3), dtype=jnp.float64))
    jforcing = jstep.Forcing3D(tau_x=jnp.asarray(tau), tau_y=jnp.asarray(tau))
    with pytest.raises((TypeError, ValueError)):
        jdo.make_step(jforcing)(jst)

    cfg = stepper.OceanConfig(nl=3, dt=20.0, m_2d=4)
    do = ocean.DistributedOcean(m, b, cfg, 0, 1, halo.Transport(),
                                device="cpu")
    t = torch.as_tensor(tau)
    with pytest.raises(RuntimeError, match="size"):
        do.make_step(stepper.Forcing3D(tau_x=t, tau_y=t))(do.init_state())


# ---------------------------------------------------------------------------
# the ocean cells (launch/ocean_dryrun.py)
# ---------------------------------------------------------------------------
def test_ocean_cells_are_jax_cells():
    from repro.launch import ocean_dryrun as jdry
    assert set(ocean_dryrun.OCEAN_CELLS) == set(jdry.OCEAN_CELLS)
    for k, c in ocean_dryrun.OCEAN_CELLS.items():
        assert dataclasses.asdict(c) == dataclasses.asdict(jdry.OCEAN_CELLS[k])


@pytest.mark.parametrize("reef", [False, True])
def test_build_cell_matches_jax(reef):
    """A cell cut to rect_mesh(8, 6): the rank's bathymetry bitwise and the
    config as JAX's build_cell gives them (one rank, float32), but for the
    backend, which JAX pins to ref and the port leaves `auto`."""
    from jax.sharding import Mesh
    from repro.launch import ocean_dryrun as jdry
    kw = dict(name="small", nx=8, ny=6, lx=64e3, ly=48e3, nl=4, m_2d=4,
              dt=30.0, depth=40.0, reef=reef, halo_exchange_period=2)
    do = ocean_dryrun.build_cell(ocean_dryrun.OceanCell(**kw), 0, 1,
                                 halo.Transport(), device="cpu")
    jdo = jdry.build_cell(jdry.OceanCell(**kw),
                          Mesh(np.array(jax.devices()[:1]), ("x",)))
    assert do.b.dtype == torch.float32 and do.spec.n_parts == 1
    np.testing.assert_array_equal(do.b.numpy(), np.asarray(jdo.b_stk)[0])
    assert (do.cfg.backend, jdo.cfg.backend) == ("auto", "ref")
    assert (dataclasses.asdict(do.cfg)
            == dataclasses.asdict(jdo.cfg) | {"backend": "auto"})
    assert do.spec.n_loc == jdo.spec.n_loc


# ---------------------------------------------------------------------------
# the spawn helper: results in rank order; a failure or a hang never waits
# ---------------------------------------------------------------------------
@pytest.fixture
def started(monkeypatch):
    """The processes that `spawn.run` starts in this test, recorded as its
    spawn context creates them: the ranks of this run and no other child of
    the test process (which, under pytest-xdist, may hold other tests')."""
    import torch.multiprocessing as mp
    procs, real = [], mp.get_context

    class Recording:
        def __init__(self, ctx):
            self.ctx = ctx

        def __getattr__(self, name):
            return getattr(self.ctx, name)

        def Process(self, *args, **kwargs):
            procs.append(self.ctx.Process(*args, **kwargs))
            return procs[-1]

    monkeypatch.setattr(mp, "get_context",
                        lambda method=None: Recording(real(method)))
    return procs


def _no_rank_left(procs, n_ranks):
    """Every rank the run started is gone (exited and reaped)."""
    return len(procs) == n_ranks and all(p.exitcode is not None
                                         for p in procs)


def test_spawn_returns_results_in_rank_order(started):
    import torch_dist_ranks as R
    from repro_torch.distributed import spawn
    assert spawn.run(R.raise_on, 3, args=(-1,), timeout_s=120) == [0, 1, 2]
    assert _no_rank_left(started, 3)


@pytest.mark.parametrize("how", ["raises", "exits"])
def test_spawn_turns_a_failed_rank_into_an_error(how, started):
    import torch_dist_ranks as R
    from repro_torch.distributed import spawn
    fn, args, msg = ((R.raise_on, (1,), "fails on purpose") if how == "raises"
                     else (R.exit_hard, (), "exited with code 3"))
    with pytest.raises(RuntimeError, match=msg):
        spawn.run(fn, 2, args=args, timeout_s=120)
    assert _no_rank_left(started, 2)


def test_spawn_ends_a_deadlocked_run_at_its_deadline(started):
    import time
    import torch_dist_ranks as R
    from repro_torch.distributed import spawn
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn.run(R.wait_for_nothing, 2, timeout_s=8)
    assert time.monotonic() - t0 < 60
    assert _no_rank_left(started, 2)
