"""The paper's GBR case (`repro_torch.gbr_reef`, the port of
`examples/gbr_reef.py`) against the JAX package's `stepper.step`, on the CPU
in float64, with every forcing term on: the Jackett EOS, Coriolis, wind
stress, a time-varying tide on `eta_open`, open-boundary T and S,
atmospheric pressure and a surface source.

Case: rect_mesh(8, 5) of 100 x 60 km, jitter 0.2, seed 5, an open boundary
at x = lx (so interior, WALL and OPEN edges are all present), the reef
bathymetry from 8 to 80 m, nl = 3, dt 40 s, m_2d = 4.  The port's side comes
from `gbr_reef.setup`; the JAX side is built here from the example's recipe.
The initial T/S carry a cross-shelf front, the open-boundary T/S differ from
the interior, and `patm` and `source` vary in space; each step takes its
forcing from `forcing_at(time)`, so the tide differs between the steps.

Tolerances: each prognostic field within 1e-10 of its own maximum, eta
within 1e-12 absolute (as tests/test_torch_stepper.py); the bathymetries
bitwise.  A term is live when switching it off in the JAX run changes some
field by more than 1e-8 of its maximum.
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
from repro_torch import convert, gbr_reef  # noqa: E402
from repro_torch.core import mesh2d as tmesh  # noqa: E402
from repro_torch.core import stepper as tstep  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

F64 = jnp.float64
LX, LY = 100e3, 60e3
NX, NY, NL, M2D, DT = 8, 5, 3, 4, 40.0
STEPS = 2
FIELDS = ("ux", "uy", "T", "S", "turb_k", "turb_eps", "nu_t", "kappa_t")
LIVE = 1e-8
TERMS = ("jackett", "coriolis", "wind", "tide", "ts_open", "patm", "source")


def _open_fn(mids):
    return mids[:, 0] > LX * (1 - 1e-9)


def _extras(node_x, node_y, nt):
    """The terms the example leaves at their defaults, made non-trivial:
    a cross-shelf T/S front over a vertical gradient, open-boundary T/S off
    the interior values, and patm / source that vary in space."""
    front = np.tanh((node_x - 0.4 * LX) / 10e3)              # (3, nt)
    layer = np.arange(NL, dtype=np.float64)[:, None, None]
    col = np.concatenate([front, front])[None]                # (1, 6, nt)
    return dict(
        T=24.0 + 2.0 * col - 0.5 * layer,
        S=35.0 - 0.4 * col + 0.05 * layer,
        T_open=np.full((NL, 6, nt), 21.5),
        S_open=np.full((NL, 6, nt), 34.2),
        patm=101325.0 + 300.0 * np.sin(np.pi * node_y / LY) * node_x / LX,
        source=2e-6 * (1.0 + 0.5 * np.cos(2 * np.pi * node_x / LX)))


def _jax_forcing(nt, t, ex, off=()):
    """The example's forcing_at (examples/gbr_reef.py) with the extra terms;
    a term in `off` is switched off (zero amplitude, or None for T/S_open)."""
    amp = 0.0 if "tide" in off else 0.8
    eta_bc = amp * jnp.sin(2 * jnp.pi * t / 44712.0) * jnp.ones((3, nt))
    wind = 0.0 if "wind" in off else 1.0
    z = lambda name: (jnp.zeros((3, nt)) if name in off
                      else jnp.asarray(ex[name]))
    ts = "ts_open" not in off
    return jstep.Forcing3D(
        forcing2d=jd2.Forcing2D(eta_open=eta_bc, patm=z("patm"),
                                source=z("source")),
        tau_x=jnp.full((3, nt), -5e-5 * wind),
        tau_y=jnp.full((3, nt), 3e-5 * wind),
        T_open=jnp.asarray(ex["T_open"]) if ts else None,
        S_open=jnp.asarray(ex["S_open"]) if ts else None)


def _forcing_np(f):
    """A JAX Forcing3D as the nested numpy dict of convert.forcing_from_numpy."""
    n = lambda x: None if x is None else np.asarray(x)
    d = {k.name: n(getattr(f, k.name)) for k in dataclasses.fields(f)
         if k.name != "forcing2d"}
    d["forcing2d"] = {k.name: n(getattr(f.forcing2d, k.name))
                      for k in dataclasses.fields(f.forcing2d)}
    return d


def _state_np(st):
    d = {f.name: np.asarray(getattr(st, f.name))
         for f in dataclasses.fields(jstep.OceanState) if f.name != "ext"}
    d["ext"] = {k: np.asarray(getattr(st.ext, k)) for k in ("eta", "qx", "qy")}
    return d


class JaxCase:
    """The JAX side: geometry, initial state and a cache of jitted steps
    (the forcing is an argument, so the tide is not frozen)."""

    def __init__(self):
        m = jmesh.rect_mesh(NX, NY, LX, LY, jitter=0.2, seed=5,
                            open_edge_fn=_open_fn)
        et = np.asarray(m.edge_type)
        assert all((et == k).any()
                   for k in (jmesh.INTERIOR, jmesh.WALL, jmesh.OPEN))
        self.geom = jgeo.geom2d_from_mesh(m, dtype=F64)
        bf = jmesh.reef_bathymetry(8.0, 80.0, LX, LY, n_reefs=25)
        pts = np.stack([np.asarray(self.geom.node_x).ravel(),
                        np.asarray(self.geom.node_y).ravel()], 1)
        self.b = bf(pts).reshape(3, m.nt)
        self.vg = JVGrid(b=jnp.asarray(self.b), nl=NL)
        self.nt = m.nt
        self.ex = _extras(np.asarray(self.geom.node_x),
                          np.asarray(self.geom.node_y), m.nt)
        st = jstep.init_state(self.geom, self.vg, T0=24.0, S0=35.0, dtype=F64)
        self.st0 = dataclasses.replace(st, T=jnp.asarray(self.ex["T"]),
                                       S=jnp.asarray(self.ex["S"]))
        self._steps = {}

    def cfg(self, backend="ref", off=()):
        return jstep.OceanConfig(
            nl=NL, dt=DT, m_2d=M2D, use_gls=True, backend=backend,
            eos_kind="linear" if "jackett" in off else "jackett",
            coriolis_f=0.0 if "coriolis" in off else -4e-5)

    def step(self, st, backend="ref", off=()):
        """One jitted step from `st` with its forcing at st.time."""
        cfg = self.cfg(backend, off)
        if cfg not in self._steps:
            self._steps[cfg] = jax.jit(
                lambda s, f: jstep.step(self.geom, self.vg, cfg, s, f))
        return self._steps[cfg](st, _jax_forcing(self.nt, st.time, self.ex,
                                                 off))

    def run(self, backend="ref", off=()):
        st = self.st0
        for _ in range(STEPS):
            st = self.step(st, backend, off)
        return _state_np(st)


@pytest.fixture(scope="module")
def jcase():
    return JaxCase()


@pytest.fixture(scope="module")
def jax_full(jcase):
    return jcase.run("ref")


def _torch_setup():
    return gbr_reef.setup(nx=NX, ny=NY, nl=NL, m_2d=M2D, dt=DT,
                          dtype=torch.float64, device="cpu")


def _torch_forcing(forcing_at, t, ex):
    """The port's forcing_at(t) with the same extra terms as the JAX run."""
    f = forcing_at(t)
    t_ = lambda name: torch.from_numpy(np.array(ex[name]))
    return dataclasses.replace(
        f, T_open=t_("T_open"), S_open=t_("S_open"),
        forcing2d=dataclasses.replace(f.forcing2d, patm=t_("patm"),
                                      source=t_("source")))


def _run_torch(backend, ex):
    geom, vg, cfg, st, forcing_at = _torch_setup()
    cfg = dataclasses.replace(cfg, backend=backend)
    st = dataclasses.replace(st, T=torch.from_numpy(np.array(ex["T"])),
                             S=torch.from_numpy(np.array(ex["S"])))
    for _ in range(STEPS):
        st = tstep.step(geom, vg, cfg, st, _torch_forcing(forcing_at, st.time,
                                                          ex))
    return convert.state_to_numpy(st)


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


# ---------------------------------------------------------------------------
# bathymetry and set-up
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["flat", "reef", "reef_seed"])
def test_bathymetry_bitwise(kind):
    rng = np.random.default_rng(4)
    p = rng.uniform(0.0, 1.0, (500, 2)) * [LX, LY]
    args = {"flat": ("flat_bathymetry", (17.5,), {}),
            "reef": ("reef_bathymetry", (8.0, 80.0, LX, LY), {"n_reefs": 25}),
            "reef_seed": ("reef_bathymetry", (12.0, 120.0, 625e3, 403.1e3),
                          {"n_reefs": 25, "seed": 11})}[kind]
    name, a, kw = args
    np.testing.assert_array_equal(getattr(tmesh, name)(*a, **kw)(p),
                                  getattr(jmesh, name)(*a, **kw)(p))


def test_setup_matches_the_example(jcase):
    """gbr_reef.setup builds the example's mesh, bathymetry, config and
    forcing: geometry and b bitwise, the tide at two times within 1e-15."""
    geom, vg, cfg, st, forcing_at = _torch_setup()
    for f in dataclasses.fields(jgeo.Geom2D):
        np.testing.assert_array_equal(getattr(geom, f.name).numpy(),
                                      np.asarray(getattr(jcase.geom, f.name)),
                                      err_msg=f.name)
    np.testing.assert_array_equal(vg.b.numpy(), jcase.b)
    assert (cfg.eos_kind, cfg.coriolis_f, cfg.use_gls) == ("jackett", -4e-5,
                                                           True)
    for t in (0.0, 40.0, 1234.5):
        jf = _forcing_np(_jax_forcing(jcase.nt, jnp.asarray(t), jcase.ex))
        tf = forcing_at(torch.tensor(t, dtype=torch.float64))
        np.testing.assert_allclose(tf.forcing2d.eta_open.numpy(),
                                   jf["forcing2d"]["eta_open"], rtol=0,
                                   atol=1e-15)
        np.testing.assert_array_equal(tf.tau_x.numpy(), jf["tau_x"])
        np.testing.assert_array_equal(tf.tau_y.numpy(), jf["tau_y"])
        assert float(tf.T_open.min()) == float(tf.T_open.max()) == 24.0
        assert float(tf.S_open.min()) == float(tf.S_open.max()) == 35.0
    assert float(forcing_at(40.0).forcing2d.eta_open.abs().max()) > 0.0


def test_forcing_from_numpy_keeps_none(jcase):
    """convert.forcing_from_numpy carries a Forcing3D across with its nested
    Forcing2D; fields that are None stay None."""
    jf = _jax_forcing(jcase.nt, jnp.asarray(40.0), jcase.ex)
    tf = convert.forcing_from_numpy(_forcing_np(jf), device="cpu")
    assert tf.forcing2d.tau_x is None and tf.forcing2d.tau_y is None
    _, _, _, _, forcing_at = _torch_setup()
    own = _torch_forcing(forcing_at, torch.tensor(40.0, dtype=torch.float64),
                         jcase.ex)
    for name in ("tau_x", "tau_y", "T_open", "S_open"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                      getattr(own, name).numpy(), err_msg=name)
    for name in ("eta_open", "patm", "source"):
        np.testing.assert_allclose(getattr(tf.forcing2d, name).numpy(),
                                   getattr(own.forcing2d, name).numpy(),
                                   rtol=0, atol=1e-15, err_msg=name)
    off = convert.forcing_from_numpy({"tau_x": None}, device="cpu")
    assert off == tstep.Forcing3D()


# ---------------------------------------------------------------------------
# the full-physics step against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("jb,tb", [("pallas_interpret", "plain"),
                                   ("ref", "ref")])
def test_gbr_steps_match_jax(jcase, jax_full, jb, tb):
    a = jax_full if jb == "ref" else jcase.run(jb)
    ops.reset_launches()
    b = _run_torch(tb, jcase.ex)
    per_step = {"solve_r": 2, "solve_w": 2, "block_thomas": 2,
                "lateral_flux": 4 if tb == "plain" else 0, "tridiag": 4}
    assert dict(ops.LAUNCHES) == {(op, tb): STEPS * n
                                  for op, n in per_step.items() if n}
    for k in FIELDS:
        assert a[k].shape == b[k].shape, k
        assert _rel(a[k], b[k]) <= 1e-10, (k, _rel(a[k], b[k]))
    np.testing.assert_allclose(b["ext"]["eta"], a["ext"]["eta"], rtol=0,
                               atol=1e-12)
    assert np.abs(b["ux"]).max() > 1e-6                 # the flow is active
    assert np.isfinite(b["T"]).all()
    np.testing.assert_allclose(float(b["time"]), STEPS * DT)


@pytest.mark.parametrize("term", TERMS)
def test_each_forcing_term_is_live(jcase, jax_full, term):
    """Switching one term off in the JAX run changes some field by more than
    LIVE of its maximum, so the comparison above holds that term."""
    off = jcase.run("ref", off=(term,))
    a = dict(jax_full, **jax_full["ext"])
    b = dict(off, **off["ext"])
    change = max(_rel(a[k], b[k]) for k in FIELDS + ("eta", "qx", "qy"))
    assert change > LIVE, (term, change)


def test_main_runs_and_prints_its_ratio(capsys):
    ratio = gbr_reef.main(["--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "physical/wall ratio" in out and "|vort| p50=" in out
    assert out.rstrip().endswith("OK")
    assert ratio > 0.0


def test_full_size_is_the_dryrun_gbr_cell():
    """gbr_reef.FULL_SIZE has the cell size, depth range, layers and dt of
    the reference's `gbr` dry-run cell, on 400 x 200 cells."""
    from repro.launch.ocean_dryrun import OCEAN_CELLS
    cell, f = OCEAN_CELLS["gbr"], gbr_reef.FULL_SIZE
    assert f["lx"] / f["nx"] == cell.lx / cell.nx
    assert f["ly"] / f["ny"] == pytest.approx(cell.ly / cell.ny, rel=1e-4)
    assert (f["nl"], f["dt"], f["depth_deep"]) == (cell.nl, cell.dt,
                                                  cell.depth)
    assert f["depth_shallow"] == 0.1 * cell.depth
    assert gbr_reef.FULL_SIZE_M2D_MIN == cell.m_2d
    assert 2 * f["nx"] * f["ny"] == 160_000


def test_full_size_setup_takes_the_larger_m2d(monkeypatch):
    """m_2d is the larger of the reference's 20 and what the thinnest
    triangle asks for at the deepest point (at a small size here)."""
    from repro_torch.quickstart import external_substeps
    for nx, lx, want in ((40, 62.5e3, 20), (16, 2.5e3, None)):
        small = dict(gbr_reef.FULL_SIZE, nx=nx, ny=nx // 2, lx=lx,
                     ly=lx * 0.645, nl=2)
        monkeypatch.setattr(gbr_reef, "FULL_SIZE", small)
        geom, vg, cfg, st, forcing_at, m_cfl = gbr_reef.full_size_setup(
            device="cpu")
        mesh = gbr_reef.reef_mesh(nx, nx // 2, lx, lx * 0.645)
        assert m_cfl == external_substeps(mesh, 45.0, depth=120.0)
        assert cfg.m_2d == max(20, m_cfl) == (want or m_cfl)
        assert (geom.nt, cfg.nl, cfg.dt) == (nx * nx, 2, 45.0)
        assert float(vg.b.max()) <= 120.0 and vg.b.dtype == torch.float64


# ---------------------------------------------------------------------------
# the one-step amplification of rounding into the GLS fields
# ---------------------------------------------------------------------------
GLS_FIELDS = ("turb_k", "turb_eps", "nu_t", "kappa_t")
AMP_SETS = 10        # seeded node sets, 24 nodes each


def _amplification(a, b, x0, x1):
    """max |field change| over max |field|, per GLS field, over the same
    relative measure of the input change."""
    din = np.abs(x1 - x0).max() / np.abs(x0).max()
    return np.array([_rel(a[k], b[k]) / din for k in GLS_FIELDS])


def test_gls_amplification_is_the_models_own(jcase, monkeypatch):
    """From a developed state (the GBR case after one JAX step), T moved by
    one ulp at 24 seeded nodes; one step in JAX (ref) and in the port
    (plain) from the clean and from the perturbed state.  The response to
    a one-ulp change is rounding noise that swings several-fold with the
    node set (the test prints each framework's min and max), so each
    framework's factor is the median over AMP_SETS node sets: the port's
    median is within 2x of JAX's for every GLS field, which shows the
    amplification is the model's own.  Then the port's last GLS update of
    each step (stage 2's, from which the step's GLS fields come) is re-run
    from the clean run's inputs with one input at a time from the
    perturbed run, which names the term that carries the change."""
    from repro_torch.core import turbulence as tturb

    st1 = jcase.step(jcase.st0)
    d1 = _state_np(st1)
    T0 = np.array(d1["T"])

    calls = []
    real = tturb.gls_step

    def spy(ts, m2, n2, dz, dt, *a, **kw):
        calls.append((ts, m2, n2, dz, dt, kw))
        return real(ts, m2, n2, dz, dt, *a, **kw)
    monkeypatch.setattr(tturb, "gls_step", spy)
    geom, vg, cfg, _, forcing_at = _torch_setup()
    cfg = dataclasses.replace(cfg, backend="plain")

    def port_step(T):
        s = convert.state_from_numpy(dict(d1, T=T), device="cpu")
        s = tstep.step(geom, vg, cfg, s, _torch_forcing(forcing_at, s.time,
                                                        jcase.ex))
        return convert.state_to_numpy(s)

    j0, t0 = _state_np(jcase.step(st1)), port_step(T0)
    clean = calls[1]
    amp_j, amp_t, swaps, d_in = [], [], [], []
    for seed in range(AMP_SETS):
        idx = np.random.default_rng(seed).choice(T0.size, 24, replace=False)
        T1 = T0.copy()
        T1.flat[idx] = np.nextafter(T1.flat[idx], np.inf)
        amp_j.append(_amplification(
            j0, _state_np(jcase.step(dataclasses.replace(
                st1, T=jnp.asarray(T1)))), T0, T1))
        amp_t.append(_amplification(t0, port_step(T1), T0, T1))
        swaps.append(calls[-1])
        d_in.append(np.abs(T1 - T0).max() / np.abs(T0).max())
    med_j, med_t = np.median(amp_j, axis=0), np.median(amp_t, axis=0)
    print("one-step amplification of a 1-ulp change of T, median over",
          AMP_SETS, "node sets (min, max):")
    for name, a, med in (("jax ref", amp_j, med_j),
                         ("port plain", amp_t, med_t)):
        print(f"  {name}:", {k: f"{m:.3e} ({lo:.2e}, {hi:.2e})"
                             for k, m, lo, hi in zip(GLS_FIELDS, med,
                                                     np.min(a, 0),
                                                     np.max(a, 0))})
    for k, a, b in zip(GLS_FIELDS, med_t, med_j):
        assert b > 1.0, (k, b)
        assert 0.5 <= a / b <= 2.0, (k, a, b)

    # attribution: swap one input of the stage-2 GLS update at a time
    ts, m2, n2, dz, dt, kw = clean
    base = real(ts, m2, n2, dz, dt, **kw)
    p = tturb.GLSParams()

    def change(out):
        return np.array([float((o - b).abs().max() / b.abs().max())
                         for o, b in zip(out, base)])
    share = {"M2 (shear)": [], "N2 (buoyancy)": [], "dz": []}
    n2_gain, at_max = [], []
    for (_, m2p, n2p, dzp, _, _), din in zip(swaps, d_in):
        full = change(real(ts, m2p, n2p, dzp, dt, **kw))
        for name, args in (("M2 (shear)", (m2p, n2, dz)),
                           ("N2 (buoyancy)", (m2, n2p, dz)),
                           ("dz", (m2, n2, dzp))):
            share[name].append(change(real(ts, *args, dt, **kw))
                               / np.maximum(full, 1e-300))
        n2_gain.append(float((n2p - n2).abs().max() / n2.abs().max()) / din)
        # the prism whose nu_t moves most: which branch of the update acts
        out = real(ts, m2, n2p, dz, dt, **kw)
        j = np.unravel_index(int((out.nu_t - base.nu_t).abs().argmax()),
                             tuple(base.nu_t.shape))
        e_lim = (p.c_mu0 ** 3) * out.k[j] * float(
            max(float(n2p[j]), 0.0) / p.galperin) ** 0.5
        at_max.append(dict(n2_negative=float(n2[j]) < 0.0,
                           galperin=bool(out.eps[j] == e_lim),
                           clamped=float(out.nu_t[j]) in (p.nu_min,
                                                          p.nu_max)))
    med = {k: np.median(v, axis=0) for k, v in share.items()}
    dominant = max(med, key=lambda n: med[n].min())
    print("stage-2 GLS update, each input alone: median share of the change "
          "all three make:", {k: np.round(v, 3).tolist()
                              for k, v in med.items()})
    print(f"N2's own change over T's (both relative to their max): median "
          f"{np.median(n2_gain):.3e}")
    print("at the prism whose nu_t moves most, over the node sets:",
          {k: sum(a[k] for a in at_max) for k in at_max[0]}, "of",
          len(at_max))
    print("dominant term:", dominant)
    assert med[dominant].min() >= 0.5, med
