"""The PyTorch port's column operators and solvers (`core/vertical.py`)
against the JAX package, in float64 on the CPU.

Tolerance 1e-12 * max(|ref|_inf, 1): the same arithmetic in another
summation order (and LAPACK's 3x3 / 6x6 solves on both sides)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import geometry as jgeo  # noqa: E402
from repro.core import mesh2d as jmesh  # noqa: E402
from repro.core import vertical as jv  # noqa: E402
from repro_torch.core import geometry as tgeo  # noqa: E402
from repro_torch.core import mesh2d as tmesh  # noqa: E402
from repro_torch.core import vertical as tv  # noqa: E402

TOL = 1e-12
NL = 3


def _close(out, ref, tol=TOL):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(out - ref).max() <= tol * scale


@pytest.fixture(scope="module")
def case():
    args = (4, 3, 2000.0, 1500.0)
    jg = jgeo.geom2d_from_mesh(jmesh.rect_mesh(*args, jitter=0.2, seed=3),
                               dtype=jnp.float64)
    tg = tgeo.geom2d_from_mesh(tmesh.rect_mesh(*args, jitter=0.2, seed=3),
                               dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(0)
    nt = tg.nt
    H = 10.0 + 10.0 * rng.random((3, nt))
    d = dict(
        jz=H / (2 * NL), H=H,
        wrel=1e-3 * rng.standard_normal((NL, 6, nt)),
        wface=1e-3 * rng.standard_normal((NL + 1, 3, nt)),
        kappa=1e-3 + 1e-2 * rng.random((NL, 6, nt)),
        drag=2.5e-3 * rng.random((3, nt)),
        u=rng.standard_normal((2, NL, 6, nt)))
    return jg, tg, d


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("with_drag", [False, True])
def test_assemble_vertical_operator(case, with_drag):
    jg, tg, d = case
    drag = d["drag"] if with_drag else None
    ja = jv.assemble_vertical_operator(jg, NL, d["jz"], d["wrel"], d["wface"],
                                       d["kappa"], d["H"], drag_coeff=drag)
    ta = tv.assemble_vertical_operator(
        tg, NL, _t(d["jz"]), _t(d["wrel"]), _t(d["wface"]), _t(d["kappa"]),
        _t(d["H"]), drag_coeff=None if drag is None else _t(drag))
    for a, b in zip(ta, ja):
        _close(a, b)
    _close(tv.blocks_matvec(ta, _t(d["u"])), jv.blocks_matvec(ja, d["u"]))


def test_mass_blocks_apply_and_solve(case):
    jg, tg, d = case
    _close(tv.mass_blocks(tg, _t(d["jz"]), NL), jv.mass_blocks(jg, d["jz"], NL))
    _close(tv.mass_apply3d(tg, _t(d["jz"]), _t(d["u"])),
           jv.mass_apply3d(jg, d["jz"], d["u"]))
    _close(tv.mass_solve3d(tg, _t(d["jz"]), _t(d["u"])),
           jv.mass_solve3d(jg, d["jz"], d["u"]))
    # M^{-1} M u == u
    back = tv.mass_solve3d(tg, _t(d["jz"]),
                           tv.mass_apply3d(tg, _t(d["jz"]), _t(d["u"])))
    _close(back, d["u"])


@pytest.mark.parametrize("k", [1, 2])
def test_implicit_system_and_block_thomas(case, k):
    jg, tg, d = case
    dtau = 15.0
    ja = jv.assemble_vertical_operator(jg, NL, d["jz"], d["wrel"], d["wface"],
                                       d["kappa"], d["H"])
    ta = tv.assemble_vertical_operator(
        tg, NL, _t(d["jz"]), _t(d["wrel"]), _t(d["wface"]), _t(d["kappa"]),
        _t(d["H"]))
    jsys = jv.implicit_system(jv.mass_blocks(jg, d["jz"], NL), ja, dtau)
    tsys = tv.implicit_system(tv.mass_blocks(tg, _t(d["jz"]), NL), ta, dtau)
    for a, b in zip(tsys, jsys):
        _close(a, b)
    rhs = d["u"][:k]
    x = tv.block_thomas_solve(tsys, _t(rhs))
    _close(x, jv.block_thomas_solve(jsys, rhs))
    _close(tv.blocks_matvec(tsys, x), rhs)              # it solves the system


def test_matrix_free_ref_solvers(case):
    jg, tg, d = case
    rng = np.random.default_rng(1)
    F = rng.standard_normal((2, NL, 6, tg.nt))
    bc = rng.standard_normal((2, 3, tg.nt))
    _close(tv.solve_r(tg, _t(F), _t(bc)), jv.solve_r(jg, F, bc))
    _close(tv.solve_w(tg, _t(F), _t(bc)), jv.solve_w(jg, F, bc))
    _close(tv.solve_w(tg, _t(F[0])), jv.solve_w(jg, F[0]))
