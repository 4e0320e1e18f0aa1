"""The rest of the single-device core of the PyTorch port against the JAX
package, on the CPU in float64: `dg2d.ssprk3_step` and `cfl_dt`,
`geometry.lumped_mass`, `vertical.blocks_dense`, and the per-call horizontal
path behind `OceanConfig(fused_horizontal=False)` (`dg3d.lat_states`,
`reflect_pair`, `lateral_flux_speed` / `field_states(nodal=False)` /
`horizontal_advdiff` / `pressure_gradient_rhs` / `continuity_rhs` without
caches), up to whole steps.

Tolerances, each against max(|JAX|_inf, 1) unless stated: 1e-13 for the
2D pieces, the mass and the dense blocks (`cfl_dt` equal); 1e-12 for the
per-call operators (the same arithmetic in another order); 1e-10 of each
field's own maximum, eta 1e-12 absolute, for two steps (as
tests/test_torch_stepper.py); the port's fused path against its per-call
path within 1e-12 * max(|x|, 1) over 3 steps (as
tests/test_horizontal.py::test_step_equivalence_fused_vs_ref).
"""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dg2d as jd2  # noqa: E402
from repro.core import dg3d as jd3  # noqa: E402
from repro.core import extrusion as jext  # noqa: E402
from repro.core import geometry as jgeo  # noqa: E402
from repro.core import mesh2d as jmesh  # noqa: E402
from repro.core import stepper as jstep  # noqa: E402
from repro.core import turbulence as jturb  # noqa: E402
from repro.core import vertical as jvert  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dg2d as td2  # noqa: E402
from repro_torch.core import dg3d as td3  # noqa: E402
from repro_torch.core import extrusion as text  # noqa: E402
from repro_torch.core import geometry as tgeo  # noqa: E402
from repro_torch.core import stepper as tstep  # noqa: E402
from repro_torch.core import turbulence as tturb  # noqa: E402
from repro_torch.core import vertical as tvert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

F64 = jnp.float64
NL = 3
H_MIN = 0.05
FIELDS = ("ux", "uy", "T", "S", "turb_k", "turb_eps", "nu_t", "kappa_t")


def _close(out, ref, tol):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1.0)
    err = np.abs(out - ref).max()
    assert err <= tol * scale, (err, scale)


def _t(x):
    return torch.from_numpy(np.array(x))


def _geom_np(jg):
    return {f.name: np.asarray(getattr(jg, f.name))
            for f in dataclasses.fields(jgeo.Geom2D)}


@pytest.fixture(scope="module")
def case():
    """A channel (interior, WALL and OPEN edges) with a shelf, carried
    across, and seeded fields of every shape the operators take."""
    m = jmesh.channel_mesh(6, 3, 3000.0, 900.0, seed=2)
    jg = jgeo.geom2d_from_mesh(m, dtype=F64)
    tg = convert.geom_from_numpy(_geom_np(jg), device="cpu")
    assert float(tg.wall.sum()) > 0 and float(tg.openb.sum()) > 0
    rng = np.random.default_rng(7)
    nt = tg.nt
    x = np.asarray(jg.node_x)
    d = dict(
        b=10.0 + 10.0 * x / 3000.0,
        eta=0.05 * np.cos(np.pi * x / 3000.0) + 0.01 * rng.standard_normal((3, nt)),
        qx=0.5 * rng.standard_normal((3, nt)),
        qy=0.5 * rng.standard_normal((3, nt)),
        eta_open=0.1 * np.exp(-x / 800.0),
        u=0.1 + 0.05 * rng.standard_normal((2, NL, 6, nt)),
        tr=np.stack([10.0 + rng.standard_normal((NL, 6, nt)),
                     35.0 + 0.1 * rng.standard_normal((NL, 6, nt))]),
        tr_open=np.stack([np.full((NL, 6, nt), 12.0),
                          np.full((NL, 6, nt), 34.0)]),
        nu=0.1 + np.abs(rng.standard_normal((NL, 6, nt))),
        fbar=0.3 * rng.standard_normal((3, 2, nt)),
        Qbar=0.5 * rng.standard_normal((2, 3, nt)),
        blocks=[0.1 * rng.standard_normal((NL, 6, 6, nt)) for _ in range(3)],
        rhs=rng.standard_normal((2, NL, 6, nt)))
    d["blocks"][0][0] = 0.0
    d["blocks"][2][-1] = 0.0
    d["blocks"][1] += 2.0 * np.eye(6)[None, :, :, None]
    return jg, tg, d


def _vgeoms(d):
    jvg = jext.VGrid(b=jnp.asarray(d["b"]), nl=NL)
    tvg = text.VGrid(b=_t(d["b"]), nl=NL)
    return (jvg, jext.layer_geometry(jvg, jnp.asarray(d["eta"]), H_MIN),
            tvg, text.layer_geometry(tvg, _t(d["eta"]), H_MIN))


# ---------------------------------------------------------------------------
# dg2d, geometry, vertical
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("forced", [False, True])
def test_ssprk3_step(case, forced):
    jg, tg, d = case
    jst = jd2.State2D(*(jnp.asarray(d[k]) for k in ("eta", "qx", "qy")))
    tst = td2.State2D(*(_t(d[k]) for k in ("eta", "qx", "qy")))
    jf, tf = jd2.Forcing2D(), td2.Forcing2D()
    if forced:
        jf = jd2.Forcing2D(eta_open=jnp.asarray(d["eta_open"]))
        tf = td2.Forcing2D(eta_open=_t(d["eta_open"]))
    jb, tb = jnp.asarray(d["b"]), _t(d["b"])
    dt = jd2.cfl_dt(jg, jb)
    assert td2.cfl_dt(tg, tb) == dt
    a = jd2.ssprk3_step(lambda s: jd2.external_rhs(jg, jb, s, jf), jst, dt)
    b = td2.ssprk3_step(lambda s: td2.external_rhs(tg, tb, s, tf), tst, dt)
    for k in ("eta", "qx", "qy"):
        _close(getattr(b, k), getattr(a, k), 1e-13)


@pytest.mark.parametrize("cfl", [0.25, 0.8])
def test_cfl_dt_equal(case, cfl):
    jg, tg, d = case
    for b in (d["b"], np.full_like(d["b"], 0.01)):     # and below 0.05 m
        assert td2.cfl_dt(tg, _t(b), cfl=cfl) == jd2.cfl_dt(jg, jnp.asarray(b),
                                                            cfl=cfl)


def test_lumped_mass(case):
    jg, tg, _ = case
    out = tgeo.lumped_mass(tg)
    assert out.shape == (1, tg.nt)
    _close(out, jgeo.lumped_mass(jg), 1e-13)


def _blocks(d):
    return (jvert.Blocks(*(jnp.asarray(x) for x in d["blocks"])),
            tvert.Blocks(*(_t(x) for x in d["blocks"])))


def test_blocks_dense(case):
    _, _, d = case
    jb, tb = _blocks(d)
    _close(tvert.blocks_dense(tb), jvert.blocks_dense(jb), 1e-13)


def test_block_thomas_vs_dense(case):
    """As tests/test_vertical.py::test_block_thomas_vs_dense, on the port."""
    _, tg, d = case
    _, tb = _blocks(d)
    nt = tg.nt
    x = tvert.block_thomas_solve(tb, _t(d["rhs"])).numpy()
    A = tvert.blocks_dense(tb).numpy()
    bd = np.moveaxis(d["rhs"].reshape(2, NL * 6, nt), -1, 0)
    xd = np.linalg.solve(A[:, None], bd[..., None])[..., 0]
    np.testing.assert_allclose(np.moveaxis(x.reshape(2, NL * 6, nt), -1, 0),
                               xd, rtol=1e-8, atol=1e-9)


def test_blocks_matvec_vs_dense(case):
    """As tests/test_vertical.py::test_blocks_matvec_vs_dense, on the port."""
    _, tg, d = case
    _, tb = _blocks(d)
    nt = tg.nt
    u = d["rhs"][0]
    y = tvert.blocks_matvec(tb, _t(u)).numpy()
    A = tvert.blocks_dense(tb).numpy()
    yd = np.einsum("tij,tj->ti", A, u.reshape(NL * 6, nt).T)
    np.testing.assert_allclose(y.reshape(NL * 6, nt).T, yd, rtol=1e-10,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# the per-call horizontal operators
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("forced", [False, True])
def test_lat_states_and_reflect_pair(case, forced):
    jg, tg, d = case
    jtr, ttr = jnp.asarray(d["tr"][0]), _t(d["tr"][0])
    jbc, tbc = jd3.LateralBC(), td3.LateralBC()
    if forced:
        jbc = jd3.LateralBC(open_value=jnp.asarray(d["tr_open"][0]))
        tbc = td3.LateralBC(open_value=_t(d["tr_open"][0]))
    for a, b in zip(td3.lat_states(tg, ttr, tbc), jd3.lat_states(jg, jtr, jbc)):
        _close(a, b, 1e-12)
    ju, tu = jnp.asarray(d["u"]), _t(d["u"])
    ja = jd3.reflect_pair(jg, jd3.lat_interp_ext(jg, ju[0]),
                          jd3.lat_interp_ext(jg, ju[1]))
    ta = td3.reflect_pair(tg, td3.lat_interp_ext(tg, tu[0]),
                          td3.lat_interp_ext(tg, tu[1]))
    for a, b in zip(ta, ja):
        _close(a, b, 1e-12)


@pytest.mark.parametrize("form", ["paper", "exact"])
def test_lateral_flux_speed_uncached(case, form):
    jg, tg, d = case
    jvg, jv, tvg, tv = _vgeoms(d)
    ju, tu = jnp.asarray(d["u"]), _t(d["u"])
    jq = jd3.transport_from_velocity(jv, ju[0], ju[1])
    tq = td3.transport_from_velocity(tv, tu[0], tu[1])
    jkw, tkw = {}, {}
    if form == "exact":
        jkw = dict(fbar_edge=jnp.asarray(d["fbar"]),
                   qbar2d=tuple(jnp.asarray(d["Qbar"])))
        tkw = dict(fbar_edge=_t(d["fbar"]), qbar2d=tuple(_t(d["Qbar"])))
    jf = jd3.lateral_flux_speed(jg, jv, jvg, jq[0], jq[1], jv.eta, jvg.b,
                                h_min=H_MIN, **jkw)
    tf = td3.lateral_flux_speed(tg, tv, tvg, tq[0], tq[1], tv.eta, tvg.b,
                                h_min=H_MIN, **tkw)
    _close(tf.speed, jf.speed, 1e-12)
    np.testing.assert_array_equal(tf.upwind.numpy(), np.asarray(jf.upwind))


@pytest.mark.parametrize("kw", ["reflect", "open", "none"])
def test_field_states_per_call(case, kw):
    jg, tg, d = case
    name = "u" if kw == "reflect" else "tr"
    jkw = {"reflect": dict(bc_reflect=True),
           "open": dict(open_values=jnp.asarray(d["tr_open"])),
           "none": {}}[kw]
    tkw = {k: (_t(v) if k == "open_values" else v) for k, v in jkw.items()}
    a = jd3.field_states(jg, jnp.asarray(d[name]), nodal=False, **jkw)
    b = td3.field_states(tg, _t(d[name]), nodal=False, **tkw)
    assert a.fx is None and b.fx is None
    for f in ("fq", "fqq", "fi", "fe", "gradf", "gno", "gradf_e"):
        try:
            _close(getattr(b, f), getattr(a, f), 1e-12)
        except AssertionError as e:
            raise AssertionError(f) from e


@pytest.mark.parametrize("tb", ["ref", "plain"])
def test_horizontal_advdiff_uncached(case, tb):
    """Momentum (reflected) and tracers (open values) through the per-call
    advdiff; the lateral term goes through lat_scatter on every backend, so
    the plain backend launches no lateral-flux kernel."""
    jg, tg, d = case
    jvg, jv, tvg, tv = _vgeoms(d)
    ju, tu = jnp.asarray(d["u"]), _t(d["u"])
    jq = jd3.transport_from_velocity(jv, ju[0], ju[1])
    tq = td3.transport_from_velocity(tv, tu[0], tu[1])
    jf = jd3.lateral_flux_speed(jg, jv, jvg, jq[0], jq[1], jv.eta, jvg.b,
                                h_min=H_MIN)
    tf = td3.lateral_flux_speed(tg, tv, tvg, tq[0], tq[1], tv.eta, tvg.b,
                                h_min=H_MIN)
    ops.reset_launches()
    out = {
        "momentum": (
            td3.horizontal_advdiff(tg, tv, NL, tu, tq[0], tq[1], tf,
                                   _t(d["nu"]), bc_reflect=True, backend=tb),
            jd3.horizontal_advdiff(jg, jv, NL, ju, jq[0], jq[1], jf,
                                   jnp.asarray(d["nu"]), bc_reflect=True)),
        "tracers": (
            td3.horizontal_advdiff(tg, tv, NL, _t(d["tr"]), tq[0], tq[1], tf,
                                   _t(d["nu"]), open_values=_t(d["tr_open"]),
                                   backend=tb),
            jd3.horizontal_advdiff(jg, jv, NL, jnp.asarray(d["tr"]), jq[0],
                                   jq[1], jf, jnp.asarray(d["nu"]),
                                   open_values=jnp.asarray(d["tr_open"]))),
        "continuity": (
            td3.continuity_rhs(tg, tv, NL, tq[0], tq[1], tf),
            jd3.continuity_rhs(jg, jv, NL, jq[0], jq[1], jf))}
    rho = 0.2 * d["tr"][0] - 2.0
    Fj, rsj = jd3.pressure_gradient_rhs(jg, jvg, jv, jnp.asarray(rho))
    Ft, rst = td3.pressure_gradient_rhs(tg, tvg, tv, _t(rho))
    out["pg_F"], out["pg_rs"] = (Ft, Fj), (rst, rsj)
    assert dict(ops.LAUNCHES) == {}
    for name, (a, b) in out.items():
        try:
            _close(a, b, 1e-12)
        except AssertionError as e:
            raise AssertionError(name) from e


# ---------------------------------------------------------------------------
# whole steps on the reference's tidal channel
# ---------------------------------------------------------------------------
def _tidal_setup(nl=4):
    """tests/test_horizontal.py::tidal_setup: channel_mesh(8, 3) of 4000 x
    900 m, 10 m deep, a tide on eta_open, open-boundary T/S."""
    m = jmesh.channel_mesh(8, 3, 4000.0, 900.0, jitter=0.15, seed=3)
    et = np.asarray(m.edge_type)
    assert all((et == k).any()
               for k in (jmesh.INTERIOR, jmesh.WALL, jmesh.OPEN))
    geom = jgeo.geom2d_from_mesh(m, dtype=F64)
    vg = jext.VGrid(b=jnp.full((3, m.nt), 10.0, F64), nl=nl)
    st = jstep.init_state(geom, vg, dtype=F64)
    eta0 = 0.05 * jnp.cos(jnp.pi * geom.node_x / 4000.0)
    st = dataclasses.replace(st, ext=jd2.State2D(eta0, st.ext.qx, st.ext.qy))
    forc = jstep.Forcing3D(
        forcing2d=jd2.Forcing2D(eta_open=0.1 * jnp.exp(-geom.node_x / 800.0)),
        T_open=jnp.full_like(st.T, 10.0), S_open=jnp.full_like(st.S, 35.0))
    return geom, vg, st, forc


def _state_np(st):
    d = {f.name: np.asarray(getattr(st, f.name))
         for f in dataclasses.fields(jstep.OceanState) if f.name != "ext"}
    d["ext"] = {k: np.asarray(getattr(st.ext, k)) for k in ("eta", "qx", "qy")}
    return d


def _forcing_np(f):
    n = lambda x: None if x is None else np.asarray(x)
    d = {k.name: n(getattr(f, k.name)) for k in dataclasses.fields(f)
         if k.name != "forcing2d"}
    d["forcing2d"] = {k.name: n(getattr(f.forcing2d, k.name))
                      for k in dataclasses.fields(f.forcing2d)}
    return d


@pytest.fixture(scope="module")
def tidal():
    geom, vg, st, forc = _tidal_setup()
    tg = convert.geom_from_numpy(_geom_np(geom), device="cpu")
    tvg = convert.vgrid_from_numpy({"b": np.asarray(vg.b), "nl": vg.nl},
                                   device="cpu")
    tforc = convert.forcing_from_numpy(_forcing_np(forc), device="cpu")
    return geom, vg, st, forc, tg, tvg, _state_np(st), tforc


def _cfgs(jb, tb, fused):
    kw = dict(nl=4, dt=20.0, m_2d=4, use_gls=True, fused_horizontal=fused)
    return (jstep.OceanConfig(**kw, backend=jb),
            tstep.OceanConfig(**kw, backend=tb))


def _torch_steps(tg, tvg, cfg, d, forc, n):
    st = convert.state_from_numpy(d, device="cpu")
    for _ in range(n):
        st = tstep.step(tg, tvg, cfg, st, forc)
    return st


@pytest.mark.parametrize("jb,tb", [("pallas_interpret", "plain"),
                                   ("ref", "ref")])
def test_per_call_steps_match_jax(tidal, jb, tb):
    """Two steps of the per-call path (fused_horizontal=False) against JAX's
    per-call path; the plain backend launches every column kernel and no
    lateral-flux kernel."""
    geom, vg, st, forc, tg, tvg, d, tforc = tidal
    jcfg, tcfg = _cfgs(jb, tb, fused=False)
    step = jax.jit(lambda s: jstep.step(geom, vg, jcfg, s, forc))
    jst = st
    for _ in range(2):
        jst = step(jst)
    ops.reset_launches()
    tst = _torch_steps(tg, tvg, tcfg, d, tforc, 2)
    per_step = {"solve_r": 2, "solve_w": 2, "block_thomas": 2, "tridiag": 4}
    assert dict(ops.LAUNCHES) == {(op, tb): 2 * n for op, n in per_step.items()}
    a, b = _state_np(jst), convert.state_to_numpy(tst)
    for k in FIELDS:
        err = np.abs(a[k] - b[k]).max() / max(np.abs(a[k]).max(), 1e-30)
        assert err <= 1e-10, (k, err)
    np.testing.assert_allclose(b["ext"]["eta"], a["ext"]["eta"], rtol=0,
                               atol=1e-12)
    assert np.abs(b["ux"]).max() > 1e-6


@pytest.mark.parametrize("tb", ["ref", "plain"])
def test_fused_matches_per_call(tidal, tb):
    """As tests/test_horizontal.py::test_step_equivalence_fused_vs_ref, on
    the port: its fused pipeline against its own per-call path."""
    _, _, _, _, tg, tvg, d, tforc = tidal
    _, cfg_call = _cfgs("ref", tb, fused=False)
    _, cfg_fus = _cfgs("ref", tb, fused=True)
    a = _torch_steps(tg, tvg, cfg_call, d, tforc, 3)
    b = _torch_steps(tg, tvg, cfg_fus, d, tforc, 3)
    for name in ("ux", "uy", "T", "S"):
        xa, xb = getattr(a, name), getattr(b, name)
        scale = max(float(xa.abs().max()), 1.0)
        assert float((xa - xb).abs().max()) < 1e-12 * scale, name
    torch.testing.assert_close(a.ext.eta, b.ext.eta, rtol=0, atol=1e-12)
    assert float(a.ux.abs().max()) > 1e-6


def _count(monkeypatch, geo, d3, modules, run):
    """Exterior edge gathers issued by the 3D horizontal pipeline (calls of
    geometry.edge_interp_ext from `modules`) and nodal neighbour gathers
    (dg3d.edge_ext_nodal6) during run(); the 2D burst's are not counted."""
    counts = {"ext_interp": 0, "ext_nodal": 0}
    orig_ext, orig_nodal = geo.edge_interp_ext, d3.edge_ext_nodal6

    def count_ext(g, f):
        if sys._getframe(1).f_globals.get("__name__", "") in modules:
            counts["ext_interp"] += 1
        return orig_ext(g, f)

    def count_nodal(g, f):
        counts["ext_nodal"] += 1
        return orig_nodal(g, f)

    with monkeypatch.context() as mp:
        mp.setattr(geo, "edge_interp_ext", count_ext)
        mp.setattr(d3, "edge_ext_nodal6", count_nodal)
        run()
    return counts


@pytest.mark.parametrize("tb", ["ref", "plain"])
@pytest.mark.parametrize("fused", [True, False])
def test_stage_gather_counts(monkeypatch, tidal, fused, tb):
    """The port's stage gathers exactly as often as JAX's on each path, both
    counted here by the monkeypatching of
    tests/test_horizontal.py::test_stage_gather_counts."""
    geom, vg, st, forc, tg, tvg, d, tforc = tidal
    jcfg, tcfg = _cfgs("ref", tb, fused)
    jcfg = dataclasses.replace(jcfg, exact_consistency=True)
    tst = convert.state_from_numpy(d, device="cpu")

    def jrun():
        turb0 = jturb.TurbState(st.turb_k, st.turb_eps, st.nu_t, st.kappa_t)
        jstep.stage(geom, vg, jcfg, st, st.ux, st.uy, st.T, st.S, st.ext.eta,
                    turb0, jcfg.dt / 2, 2, True, forc)

    def trun():
        turb0 = tturb.TurbState(tst.turb_k, tst.turb_eps, tst.nu_t,
                                tst.kappa_t)
        tstep.stage(tg, tvg, tcfg, tst, tst.ux, tst.uy, tst.T, tst.S,
                    tst.ext.eta, turb0, tcfg.dt / 2, 2, True, tforc)

    a = _count(monkeypatch, jgeo, jd3,
               ("repro.core.dg3d", "repro.core.horizontal"), jrun)
    b = _count(monkeypatch, tgeo, td3,
               ("repro_torch.core.dg3d", "repro_torch.core.horizontal"), trun)
    assert b == a, (b, a)
    assert a == ({"ext_interp": 13, "ext_nodal": 2} if fused
                 else {"ext_interp": 21, "ext_nodal": 0})
