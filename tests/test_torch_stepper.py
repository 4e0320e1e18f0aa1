"""Two steps of the PyTorch port against two steps of the JAX package's
`stepper.step`, on the CPU in float64, from the same state (carried across
with `repro_torch.convert`): the port's `plain` backend against JAX's
`pallas_interpret`, and the port's `ref` against JAX's `ref`.

Configuration: that of `tests/test_dispatch.py::_step_setup`, rect_mesh(4, 3)
(nt=24), nl=3, m_2d=4, GLS on.  Tolerance: each prognostic field within
1e-10 of its own maximum (the JAX backends agree with each other to 1e-11;
two frameworks' LAPACK and libm round differently over 2 steps), eta
within 1e-12 absolute.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dg2d as jd2  # noqa: E402
from repro.core import geometry as jgeo  # noqa: E402
from repro.core import mesh2d as jmesh  # noqa: E402
from repro.core import stepper as jstep  # noqa: E402
from repro.core.extrusion import VGrid as JVGrid  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import geometry as tgeo  # noqa: E402
from repro_torch.core import mesh2d as tmesh  # noqa: E402
from repro_torch.core import stepper as tstep  # noqa: E402
from repro_torch.core.extrusion import VGrid  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

F64 = jnp.float64
FIELDS = ("ux", "uy", "T", "S", "turb_k", "turb_eps", "nu_t", "kappa_t")
STEPS = 2


def _jax_setup():
    m = jmesh.rect_mesh(4, 3, 2000.0, 1500.0, jitter=0.2, seed=3)
    geom = jgeo.geom2d_from_mesh(m, dtype=F64)
    vg = JVGrid(b=jnp.full((3, m.nt), 20.0, F64), nl=3)
    st = jstep.init_state(geom, vg, dtype=F64)
    eta0 = (0.05 * jnp.cos(jnp.pi * geom.node_x / 2000.0)
            * jnp.cos(jnp.pi * geom.node_y / 1500.0))
    Tf = 10.0 + 2.0 * jnp.exp(-((geom.node_x - 800.0) ** 2
                                + (geom.node_y - 600.0) ** 2) / 4e5)
    T0 = jnp.broadcast_to(jnp.concatenate([Tf, Tf])[None], st.T.shape)
    st = dataclasses.replace(st, ext=jd2.State2D(eta0, st.ext.qx, st.ext.qy),
                             T=T0)
    return geom, vg, st


def _state_np(st):
    d = {f.name: np.asarray(getattr(st, f.name))
         for f in dataclasses.fields(jstep.OceanState) if f.name != "ext"}
    d["ext"] = {k: np.asarray(getattr(st.ext, k)) for k in ("eta", "qx", "qy")}
    return d


def _cfgs(backend_jax, backend_torch):
    kw = dict(nl=3, dt=20.0, m_2d=4, use_gls=True)
    return (jstep.OceanConfig(**kw, backend=backend_jax),
            tstep.OceanConfig(**kw, backend=backend_torch))


@pytest.fixture(scope="module")
def case():
    geom, vg, st = _jax_setup()
    gd = {f.name: np.asarray(getattr(geom, f.name))
          for f in dataclasses.fields(jgeo.Geom2D)}
    tg = convert.geom_from_numpy(gd, device="cpu")
    tvg = convert.vgrid_from_numpy({"b": np.asarray(vg.b), "nl": vg.nl},
                                   device="cpu")
    return geom, vg, st, tg, tvg, _state_np(st)


def _run_torch(tg, tvg, cfg, d):
    st = convert.state_from_numpy(d, device="cpu")
    for _ in range(STEPS):
        st = tstep.step(tg, tvg, cfg, st)
    return st


def _assert_match(jst, tst):
    a, b = _state_np(jst), convert.state_to_numpy(tst)
    for k in FIELDS:
        x, y = a[k], b[k]
        assert x.shape == y.shape, k
        err = np.abs(x - y).max() / max(np.abs(x).max(), 1e-30)
        assert err <= 1e-10, (k, err)
    np.testing.assert_allclose(b["ext"]["eta"], a["ext"]["eta"], rtol=0,
                               atol=1e-12)
    assert np.abs(b["ux"]).max() > 1e-6                 # the flow is active
    np.testing.assert_allclose(float(tst.time), STEPS * 20.0)


@pytest.mark.parametrize("jb,tb", [("pallas_interpret", "plain"),
                                   ("ref", "ref")])
def test_two_steps_match_jax(case, jb, tb):
    geom, vg, st, tg, tvg, d = case
    jcfg, tcfg = _cfgs(jb, tb)
    step = jax.jit(lambda s: jstep.step(geom, vg, jcfg, s))
    jst = st
    for _ in range(STEPS):
        jst = step(jst)
    ops.reset_launches()
    tst = _run_torch(tg, tvg, tcfg, d)
    per_step = {"solve_r": 2, "solve_w": 2, "block_thomas": 2,
                "lateral_flux": 4 if tb == "plain" else 0, "tridiag": 4}
    assert dict(ops.LAUNCHES) == {(op, tb): STEPS * n
                                  for op, n in per_step.items() if n}
    _assert_match(jst, tst)


def test_own_geometry_gives_the_same_step(case):
    """The port's own mesh + geometry builders reproduce the carried-across
    JAX geometry's step."""
    _, _, _, tg, tvg, d = case
    m = tmesh.rect_mesh(4, 3, 2000.0, 1500.0, jitter=0.2, seed=3)
    own = tgeo.geom2d_from_mesh(m, dtype=torch.float64, device="cpu")
    _, tcfg = _cfgs("ref", "plain")
    a = _run_torch(tg, tvg, tcfg, d)
    b = _run_torch(own, tvg, tcfg, d)
    for k in FIELDS:
        torch.testing.assert_close(getattr(b, k), getattr(a, k), rtol=1e-13,
                                   atol=0)


def _basin(nl=4, shelf=False):
    m = tmesh.rect_mesh(6, 5, 2000.0, 1500.0, jitter=0.2, seed=3)
    geom = tgeo.geom2d_from_mesh(m, dtype=torch.float64, device="cpu")
    if shelf:
        bf = tmesh.shelf_bathymetry(8.0, 20.0, 2000.0)
        b = torch.stack([torch.as_tensor(bf(np.stack(
            [geom.node_x[i].numpy(), geom.node_y[i].numpy()], 1)))
            for i in range(3)])
    else:
        b = torch.full((3, m.nt), 20.0, dtype=torch.float64)
    return geom, VGrid(b=b, nl=nl)


def test_lake_at_rest_3d():
    geom, vg = _basin(shelf=True)
    cfg = tstep.OceanConfig(nl=4, dt=30.0, m_2d=8, use_gls=False,
                            eos_kind="linear")
    st = tstep.init_state(geom, vg)
    for _ in range(3):
        st = tstep.step(geom, vg, cfg, st)
    for x in (st.ext.eta, st.ux, st.uy):
        assert float(x.abs().max()) < 1e-10


def test_uniform_tracer_stays_uniform():
    geom, vg = _basin()
    cfg = tstep.OceanConfig(nl=4, dt=20.0, m_2d=8, use_gls=True,
                            eos_kind="linear")
    st = tstep.init_state(geom, vg)
    eta0 = 0.05 * torch.cos(torch.pi * geom.node_x / 2000.0)
    st = dataclasses.replace(st, ext=dataclasses.replace(st.ext, eta=eta0))
    for _ in range(5):
        st = tstep.step(geom, vg, cfg, st)
    assert float((st.T - 10.0).abs().max()) < 1e-10
    assert float((st.S - 35.0).abs().max()) < 1e-10
    assert float(st.ux.abs().max()) > 1e-6


def test_unported_paths_raise(case):
    """The distributed exchange hooks are not ported yet (the per-call
    horizontal path is: tests/test_torch_core_rest.py)."""
    _, _, _, tg, tvg, d = case
    st = convert.state_from_numpy(d, device="cpu")
    cfg = tstep.OceanConfig(nl=3, dt=20.0, m_2d=4)
    with pytest.raises(NotImplementedError):
        tstep.step(tg, tvg, cfg, st, exchange2d=lambda s: s)
