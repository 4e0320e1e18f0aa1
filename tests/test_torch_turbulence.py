"""The PyTorch port's GLS closure (`core/turbulence.py`) against the JAX
package, in float64 on the CPU.  Tolerance 1e-12 relative to the field's
maximum (the closure's outputs are small numbers: k ~ 1e-4, eps ~ 1e-8)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import turbulence as jt  # noqa: E402
from repro_torch.core import turbulence as tt  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = 1e-12


def _close(out, ref, tol=TOL):
    out, ref = out.numpy(), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= tol * scale


def _t(x):
    return torch.from_numpy(np.array(x))


def test_thomas_solve():
    rng = np.random.default_rng(0)
    nl, nt = 6, 17
    dl, du = -rng.random((nl, nt)), -rng.random((nl, nt))
    d = 3.0 + rng.random((nl, nt))
    b = rng.standard_normal((nl, nt))
    _close(tt.thomas_solve(_t(dl), _t(d), _t(du), _t(b)),
           jt.thomas_solve(*map(jnp.asarray, (dl, d, du, b))))


def test_init_and_to_nodes():
    a, b = tt.init_turbulence(4, 9, dtype=torch.float64), jt.init_turbulence(
        4, 9, dtype=jnp.float64)
    for x, y in zip(a, b):
        _close(x, y, 0.0)
    f = np.random.default_rng(1).random((4, 9))
    _close(tt.to_nodes(_t(f)), jt.to_nodes(jnp.asarray(f)), 0.0)


def _gls_case(sign):
    """A GLS state, shear and buoyancy of both signs of N2, and dz, as numpy."""
    rng = np.random.default_rng(int(2 + sign))
    nl, nt = 5, 23
    ux = 0.1 * rng.standard_normal((nl, 6, nt))
    uy = 0.1 * rng.standard_normal((nl, 6, nt))
    # density anomaly increasing (sign 1) or decreasing (-1) with depth
    depth = np.concatenate([np.arange(nl)[:, None], np.arange(1, nl + 1)[:, None]],
                           axis=1).repeat(3, axis=1)[..., None]
    rho = 0.05 * sign * depth + 1e-3 * rng.standard_normal(
        (nl, 6, nt))
    dz = 1.0 + rng.random((1, nt))
    turb = [1e-4 * (1 + rng.random((nl, nt))), 1e-8 * (1 + rng.random((nl, nt))),
            1e-3 * (1 + rng.random((nl, nt))), 1e-3 * (1 + rng.random((nl, nt)))]
    return ux, uy, rho, dz, turb


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_shear_buoyancy_and_gls_step(sign):
    """Both signs of N2, so both branches of c3 and of the limiter run."""
    rng = np.random.default_rng(int(2 + sign))
    nl, nt = 5, 23
    ux = 0.1 * rng.standard_normal((nl, 6, nt))
    uy = 0.1 * rng.standard_normal((nl, 6, nt))
    # density anomaly increasing (sign 1) or decreasing (-1) with depth
    depth = np.concatenate([np.arange(nl)[:, None], np.arange(1, nl + 1)[:, None]],
                           axis=1).repeat(3, axis=1)[..., None]
    rho = 0.05 * sign * depth + 1e-3 * rng.standard_normal(
        (nl, 6, nt))
    dz = 1.0 + rng.random((1, nt))
    m2a, n2a = tt.shear_and_buoyancy(_t(ux), _t(uy), _t(rho), _t(dz))
    m2b, n2b = jt.shear_and_buoyancy(*map(jnp.asarray, (ux, uy, rho, dz)))
    _close(m2a, m2b)
    _close(n2a, n2b)
    # the JAX package's convention, which the port keeps:
    # N2 = (g/rho0) (rho_top - rho_bottom) / dz
    assert float(n2a.mean()) * sign < 0
    ts = tt.TurbState(*(_t(x) for x in (
        1e-4 * (1 + rng.random((nl, nt))), 1e-8 * (1 + rng.random((nl, nt))),
        1e-3 * (1 + rng.random((nl, nt))), 1e-3 * (1 + rng.random((nl, nt))))))
    js = jt.TurbState(*(jnp.asarray(x.numpy()) for x in ts))
    a = tt.gls_step(ts, m2a, n2a, _t(dz), 15.0)
    b = jt.gls_step(js, m2b, n2b, jnp.asarray(dz), 15.0)
    for name, x, y in zip(("k", "eps", "nu_t", "kappa_t"), a, b):
        try:
            _close(x, y)
        except AssertionError as e:
            raise AssertionError(name) from e
    assert bool((a.k > 0).all()) and bool((a.eps > 0).all())


@pytest.mark.parametrize("backend", ["plain", "ref"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_gls_step_through_ops_tridiag(backend, sign):
    """The stepper's route: the diffusion solves through `ops.tridiag` on a
    named CPU backend equal those on the default (plain on CPU tensors)
    bitwise, two launches a GLS step, and match JAX `gls_step`."""
    ux, uy, rho, dz, turb = _gls_case(sign)
    m2, n2 = tt.shear_and_buoyancy(_t(ux), _t(uy), _t(rho), _t(dz))
    ts = tt.TurbState(*map(_t, turb))
    ops.reset_launches()
    a = tt.gls_step(ts, m2, n2, _t(dz), 15.0, backend=backend)
    assert dict(ops.LAUNCHES) == {("tridiag", backend): 2}
    ops.reset_launches()
    b = tt.gls_step(ts, m2, n2, _t(dz), 15.0)
    assert dict(ops.LAUNCHES) == {("tridiag", "plain"): 2}
    m2j, n2j = jt.shear_and_buoyancy(*map(jnp.asarray, (ux, uy, rho, dz)))
    c = jt.gls_step(jt.TurbState(*map(jnp.asarray, turb)), m2j, n2j,
                    jnp.asarray(dz), 15.0)
    for name, x, y, z in zip(("k", "eps", "nu_t", "kappa_t"), a, b, c):
        assert torch.equal(x, y), name
        try:
            _close(x, z)
        except AssertionError as e:
            raise AssertionError(name) from e
