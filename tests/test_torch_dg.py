"""The PyTorch port's 2D external mode (`core/dg2d.py`) and the fused
horizontal DG operators (`core/dg3d.py`, `core/horizontal.py`) against the
JAX package, in float64 on the CPU.

The channel mesh has WALL and OPEN edges, so every boundary fixup runs.
Tolerance 1e-12 * max(|ref|_inf, 1): the same arithmetic, summed in
another order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dg2d as jd2  # noqa: E402
from repro.core import dg3d as jd3  # noqa: E402
from repro.core import extrusion as jext  # noqa: E402
from repro.core import geometry as jgeo  # noqa: E402
from repro.core import horizontal as jhor  # noqa: E402
from repro.core import mesh2d as jmesh  # noqa: E402
from repro_torch.core import dg2d as td2  # noqa: E402
from repro_torch.core import dg3d as td3  # noqa: E402
from repro_torch.core import extrusion as text  # noqa: E402
from repro_torch.core import geometry as tgeo  # noqa: E402
from repro_torch.core import horizontal as thor  # noqa: E402
from repro_torch.core import mesh2d as tmesh  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = 1e-12
NL = 3
H_MIN = 0.05


def _close(out, ref, tol=TOL):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(out - ref).max() <= tol * scale


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def case():
    args = (6, 3, 3000.0, 900.0)
    jg = jgeo.geom2d_from_mesh(jmesh.channel_mesh(*args, seed=2),
                               dtype=jnp.float64)
    tg = tgeo.geom2d_from_mesh(tmesh.channel_mesh(*args, seed=2),
                               dtype=torch.float64, device="cpu")
    assert float(tg.wall.sum()) > 0 and float(tg.openb.sum()) > 0
    rng = np.random.default_rng(3)
    nt = tg.nt
    x = np.asarray(jg.node_x)
    d = dict(
        b=10.0 + 10.0 * x / 3000.0,
        eta=0.05 * np.cos(np.pi * x / 3000.0) + 0.01 * rng.standard_normal((3, nt)),
        qx=0.5 * rng.standard_normal((3, nt)),
        qy=0.5 * rng.standard_normal((3, nt)),
        f3x=1e-3 * rng.standard_normal((3, nt)),
        f3y=1e-3 * rng.standard_normal((3, nt)),
        u=0.1 * rng.standard_normal((2, NL, 6, nt)),
        tr=np.stack([10.0 + rng.standard_normal((NL, 6, nt)),
                     35.0 + 0.1 * rng.standard_normal((NL, 6, nt))]),
        tr_open=np.stack([np.full((NL, 6, nt), 12.0),
                          np.full((NL, 6, nt), 34.0)]))
    return jg, tg, d


def _vgeoms(d):
    jvg = jext.VGrid(b=jnp.asarray(d["b"]), nl=NL)
    tvg = text.VGrid(b=_t(d["b"]), nl=NL)
    return (jvg, jext.layer_geometry(jvg, jnp.asarray(d["eta"]), H_MIN),
            tvg, text.layer_geometry(tvg, _t(d["eta"]), H_MIN))


def _external(jg, tg, d, m=4, dt=20.0):
    jst = jd2.State2D(*(jnp.asarray(d[k]) for k in ("eta", "qx", "qy")))
    tst = td2.State2D(*(_t(d[k]) for k in ("eta", "qx", "qy")))
    jr = jd2.run_external(jg, jnp.asarray(d["b"]), jst, dt, m, jd2.Forcing2D(),
                          jnp.asarray(d["f3x"]), jnp.asarray(d["f3y"]),
                          h_min=H_MIN)
    tr = td2.run_external(tg, _t(d["b"]), tst, dt, m, td2.Forcing2D(),
                          _t(d["f3x"]), _t(d["f3y"]), h_min=H_MIN)
    return jr, tr


def test_external_rhs(case):
    jg, tg, d = case
    jst = jd2.State2D(*(jnp.asarray(d[k]) for k in ("eta", "qx", "qy")))
    tst = td2.State2D(*(_t(d[k]) for k in ("eta", "qx", "qy")))
    jr = jd2.external_rhs(jg, jnp.asarray(d["b"]), jst, jd2.Forcing2D(),
                          jnp.asarray(d["f3x"]), jnp.asarray(d["f3y"]), H_MIN)
    tr = td2.external_rhs(tg, _t(d["b"]), tst, td2.Forcing2D(),
                          _t(d["f3x"]), _t(d["f3y"]), H_MIN)
    for k in ("eta", "qx", "qy"):
        _close(getattr(tr, k), getattr(jr, k))
    # State2D arithmetic
    s = 0.5 * tst + tst * 2.0
    _close(s.eta, 2.5 * d["eta"])


def test_run_external_m4(case):
    jg, tg, d = case
    jr, tr = _external(jg, tg, d)
    for k in ("eta", "qx", "qy"):
        _close(getattr(tr.state, k), getattr(jr.state, k))
    for k in ("q_bar_x", "q_bar_y", "f2d_x", "f2d_y", "fbar_edge"):
        _close(getattr(tr, k), getattr(jr, k))


def _pipeline(jg, tg, d, jb, tb):
    """The fused stage's horizontal RHS in both frameworks, from the same
    inputs: caches, both flux speeds, field states, advection, diffusion."""
    jvg, jv, tvg, tv = _vgeoms(d)
    jr, tr = _external(jg, tg, d)
    out = {}
    jhc = jhor.stage_cache(jg, jv, H_MIN)
    thc = thor.stage_cache(tg, tv, H_MIN)
    ju, tu = jnp.asarray(d["u"]), _t(d["u"])
    jq = jd3.transport_from_velocity(jv, ju[0], ju[1])
    tq = td3.transport_from_velocity(tv, tu[0], tu[1])
    jtc = jhor.transport_cache(jg, jv, jvg, jhc, jq[0], jq[1], h_min=H_MIN)
    ttc = thor.transport_cache(tg, tv, tvg, thc, tq[0], tq[1], h_min=H_MIN)
    out["speed_pred"] = (ttc.flux.speed, jtc.flux.speed)
    jqb = jd3.consistent_transport(jv, ju[0], ju[1], jr.q_bar_x, jr.q_bar_y, NL)
    tqb = td3.consistent_transport(tv, tu[0], tu[1], tr.q_bar_x, tr.q_bar_y, NL)
    out["qbar"] = (tqb, jqb)
    jtcb = jhor.transport_cache(jg, jv, jvg, jhc, jqb[0], jqb[1], h_min=H_MIN,
                                fbar_edge=jr.fbar_edge,
                                qbar2d=(jr.q_bar_x, jr.q_bar_y))
    ttcb = thor.transport_cache(tg, tv, tvg, thc, tqb[0], tqb[1], h_min=H_MIN,
                                fbar_edge=tr.fbar_edge,
                                qbar2d=(tr.q_bar_x, tr.q_bar_y))
    out["speed_exact"] = (ttcb.flux.speed, jtcb.flux.speed)
    out["continuity"] = (
        td3.continuity_rhs(tg, tv, NL, tqb[0], tqb[1], ttcb.flux, ttcb),
        jd3.continuity_rhs(jg, jv, NL, jqb[0], jqb[1], jtcb.flux, tcache=jtcb))

    jfs = jd3.field_states(jg, ju, bc_reflect=True)
    tfs = td3.field_states(tg, tu, bc_reflect=True)
    jtr, ttr = jnp.asarray(d["tr"]), _t(d["tr"])
    jfs_tr = jd3.field_states(jg, jtr, open_values=jnp.asarray(d["tr_open"]))
    tfs_tr = td3.field_states(tg, ttr, open_values=_t(d["tr_open"]))
    for name in ("fq", "fqq", "fi", "fe", "fx", "gradf", "gno", "gradf_e"):
        out[f"fs_u.{name}"] = (getattr(tfs, name), getattr(jfs, name))
        out[f"fs_tr.{name}"] = (getattr(tfs_tr, name), getattr(jfs_tr, name))

    jnu = jd3.smagorinsky_nu(jg, ju[0], ju[1], 0.1)
    tnu = td3.smagorinsky_nu(tg, tu[0], tu[1], 0.1)
    out["smagorinsky"] = (tnu, jnu)
    out["okubo"] = (td3.okubo_kappa(tg, NL), jd3.okubo_kappa(jg, NL))
    out["adv_pred"] = (
        td3.horizontal_advection(tg, tv, NL, tu, tq[0], tq[1], ttc.flux, ttc,
                                 tfs, backend=tb),
        jd3.horizontal_advection(jg, jv, NL, ju, jq[0], jq[1], jtc.flux,
                                 tcache=jtc, fcache=jfs, backend=jb))
    out["diff_u"] = (
        td3.horizontal_diffusion(tg, tv, NL, tu, tnu, thc, tfs),
        jd3.horizontal_diffusion(jg, jv, NL, ju, jnu, cache=jhc, fcache=jfs))
    kap = td3.okubo_kappa(tg, NL)
    tm, tt = thor.advdiff_momentum_tracers(
        tg, tv, NL, tu, ttr, tqb[0], tqb[1], ttcb.flux, tnu, kap, thc, ttcb,
        fs_u=tfs, fs_tr=tfs_tr, backend=tb)
    jm, jt = jhor.advdiff_momentum_tracers(
        jg, jv, NL, ju, jtr, jqb[0], jqb[1], jtcb.flux, jnu,
        jd3.okubo_kappa(jg, NL), fs_u=jfs, fs_tr=jfs_tr, cache=jhc,
        tcache=jtcb, backend=jb)
    out["advdiff_m"] = (tm, jm)
    out["advdiff_tr"] = (tt, jt)
    rho = 0.2 * d["tr"][0] - 2.0
    Fj, rsj = jd3.pressure_gradient_rhs(jg, jvg, jv, jnp.asarray(rho), cache=jhc)
    Ft, rst = td3.pressure_gradient_rhs(tg, tvg, tv, _t(rho), thc)
    out["pg_F"] = (Ft, Fj)
    out["pg_rs"] = (rst, rsj)
    return out


@pytest.mark.parametrize("jb,tb", [("ref", "ref"),
                                   ("pallas_interpret", "plain")])
def test_fused_horizontal_pipeline(case, jb, tb):
    jg, tg, d = case
    ops.reset_launches()
    for name, (a, b) in _pipeline(jg, tg, d, jb, tb).items():
        try:
            _close(a, b)
        except AssertionError as e:
            raise AssertionError(name) from e
    expect = ({("lateral_flux", "plain"): 2} if tb == "plain" else {})
    assert dict(ops.LAUNCHES) == expect


def test_ref_and_plain_lateral_terms_agree(case):
    """The ref backend's qp-level scatter and the kernel path's fused term
    compute the same horizontal advection."""
    jg, tg, d = case
    a = _pipeline(jg, tg, d, "ref", "ref")
    b = _pipeline(jg, tg, d, "ref", "plain")
    for name in ("adv_pred", "advdiff_m", "advdiff_tr"):
        _close(a[name][0], b[name][0])
