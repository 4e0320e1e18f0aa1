"""The step's three non-default switches, held against the JAX package: two
f64 steps of the port against two of JAX `stepper.step` from the same
state, on both backend pairs (port `plain` against JAX `pallas_interpret`,
port `ref` against JAX `ref`), with the switch set in both:

  * ``implicit_stage1=False``: both stages explicit (no block-Thomas
    solve), GLS advanced last in each stage (`stage.turbulence_final`);
  * ``exact_consistency=False``: the lateral flux of the continuity
    equation without the external mode's edge fluxes;
  * ``use_gls=False``: no turbulence closure; the mixing coefficients stay
    the state's.

Case and tolerance: those of `tests/test_torch_stepper.py` (rect_mesh(4, 3),
nl=3, dt 20 s, m_2d 4, a surface tilt and a warm patch); each prognostic
field within 1e-10 of its own maximum, eta within 1e-12 absolute.  The
launch counts a step follow each switch.
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
from repro_torch.core import stepper as tstep  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

F64 = jnp.float64
FIELDS = ("ux", "uy", "T", "S", "turb_k", "turb_eps", "nu_t", "kappa_t")
STEPS = 2
DT = 20.0

SWITCHES = {
    "implicit_stage1": dict(implicit_stage1=False),
    "exact_consistency": dict(exact_consistency=False),
    "use_gls": dict(use_gls=False),
}
# kernel calls a step under each switch (the defaults: 2/2/2/4/4)
PER_STEP = {
    "implicit_stage1": dict(solve_r=2, solve_w=2, block_thomas=0,
                            lateral_flux=4, tridiag=4),
    "exact_consistency": dict(solve_r=2, solve_w=2, block_thomas=2,
                              lateral_flux=4, tridiag=4),
    "use_gls": dict(solve_r=2, solve_w=2, block_thomas=2, lateral_flux=4,
                    tridiag=0),
}
PAIRS = [("pallas_interpret", "plain"), ("ref", "ref")]


def _state_np(st):
    d = {f.name: np.asarray(getattr(st, f.name))
         for f in dataclasses.fields(jstep.OceanState) if f.name != "ext"}
    d["ext"] = {k: np.asarray(getattr(st.ext, k)) for k in ("eta", "qx", "qy")}
    return d


@pytest.fixture(scope="module")
def case():
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
    gd = {f.name: np.asarray(getattr(geom, f.name))
          for f in dataclasses.fields(jgeo.Geom2D)}
    tg = convert.geom_from_numpy(gd, device="cpu")
    tvg = convert.vgrid_from_numpy({"b": np.asarray(vg.b), "nl": vg.nl},
                                   device="cpu")
    return geom, vg, st, tg, tvg, _state_np(st)


@pytest.mark.parametrize("jb,tb", PAIRS)
@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_switch_matches_jax(case, switch, jb, tb):
    geom, vg, st, tg, tvg, d = case
    kw = dict(nl=3, dt=DT, m_2d=4, **SWITCHES[switch])
    jcfg = jstep.OceanConfig(**kw, backend=jb)
    tcfg = tstep.OceanConfig(**kw, backend=tb)

    step = jax.jit(lambda s: jstep.step(geom, vg, jcfg, s))
    jst = st
    for _ in range(STEPS):
        jst = step(jst)

    ops.reset_launches()
    tst = convert.state_from_numpy(d, device="cpu")
    for _ in range(STEPS):
        tst = tstep.step(tg, tvg, tcfg, tst)
    per_step = dict(PER_STEP[switch])
    if tb == "ref":
        per_step["lateral_flux"] = 0            # ref scatters at the qps
    assert dict(ops.LAUNCHES) == {(op, tb): STEPS * n
                                  for op, n in per_step.items() if n}

    a, b = _state_np(jst), convert.state_to_numpy(tst)
    for k in FIELDS:
        x, y = a[k], b[k]
        assert x.shape == y.shape, k
        assert np.isfinite(y).all(), k
        err = np.abs(x - y).max() / max(np.abs(x).max(), 1e-30)
        assert err <= 1e-10, (k, err)
    np.testing.assert_allclose(b["ext"]["eta"], a["ext"]["eta"], rtol=0,
                               atol=1e-12)
    assert np.abs(b["ux"]).max() > 1e-6                 # the flow is active
    np.testing.assert_allclose(float(tst.time), STEPS * DT)


def test_switches_change_the_step(case):
    """Each switch moves the port's state away from the default step's: the
    tests above compare a branch that runs."""
    _, _, _, tg, tvg, d = case
    base = dict(nl=3, dt=DT, m_2d=4, backend="plain")

    def run(**kw):
        st = convert.state_from_numpy(d, device="cpu")
        for _ in range(STEPS):
            st = tstep.step(tg, tvg, tstep.OceanConfig(**base, **kw), st)
        return st
    ref = run()
    for switch, kw in SWITCHES.items():
        st = run(**kw)
        moved = max(float((getattr(st, f) - getattr(ref, f)).abs().max())
                    / max(float(getattr(ref, f).abs().max()), 1e-30)
                    for f in FIELDS)
        assert moved > 1e-8, (switch, moved)
