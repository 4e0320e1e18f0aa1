"""The PyTorch port's mesh, geometry, extrusion and EOS against the JAX
package, in float64 on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import eos as jeos  # noqa: E402
from repro.core import extrusion as jext  # noqa: E402
from repro.core import geometry as jgeo  # noqa: E402
from repro.core import mesh2d as jmesh  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import eos as teos  # noqa: E402
from repro_torch.core import extrusion as text  # noqa: E402
from repro_torch.core import geometry as tgeo  # noqa: E402
from repro_torch.core import mesh2d as tmesh  # noqa: E402

TOL = 1e-13
MESHES = {
    "rect": lambda m: m.rect_mesh(5, 4, 2000.0, 1500.0, jitter=0.2, seed=3),
    "channel": lambda m: m.channel_mesh(6, 3, 3000.0, 900.0, jitter=0.15,
                                        seed=2),
}


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(initial=0.0), 1.0)
    assert np.abs(a - b).max(initial=0.0) <= tol * scale


def _pair(kind):
    jm, tm = MESHES[kind](jmesh), MESHES[kind](tmesh)
    jg = jgeo.geom2d_from_mesh(jm, dtype=jnp.float64)
    tg = tgeo.geom2d_from_mesh(tm, dtype=torch.float64, device="cpu")
    return jm, tm, jg, tg


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_mesh_matches_jax(kind):
    jm, tm, _, _ = _pair(kind)
    for f in ("xy", "tri", "neigh_tri", "neigh_edge", "edge_type"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_geom2d_fields_match_jax(kind):
    _, _, jg, tg = _pair(kind)
    for f in dataclasses.fields(jgeo.Geom2D):
        a, b = getattr(tg, f.name), np.asarray(getattr(jg, f.name))
        if f.name in ("ext_tri", "ext_na", "ext_nb"):
            assert a.dtype == torch.int64
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            assert a.dtype == torch.float64
            _close(a.numpy(), b)
    if kind == "channel":
        assert float(tg.openb.sum()) > 0 and float(tg.wall.sum()) > 0


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_geom_carried_across_equals_own(kind):
    _, _, jg, tg = _pair(kind)
    d = {f.name: np.asarray(getattr(jg, f.name))
         for f in dataclasses.fields(jgeo.Geom2D)}
    carried = convert.geom_from_numpy(d, device="cpu")
    for f in dataclasses.fields(tgeo.Geom2D):
        np.testing.assert_array_equal(getattr(carried, f.name).numpy(),
                                      getattr(tg, f.name).numpy())


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_scatters_and_interps_match_jax(kind):
    _, _, jg, tg = _pair(kind)
    rng = np.random.default_rng(7)
    nt = tg.nt
    f = rng.standard_normal((2, 3, nt))
    g_edge = rng.standard_normal((2, 3, 2, nt))
    g_vol = rng.standard_normal((2, 3, nt))
    t = torch.from_numpy
    _close(tgeo.edge_scatter(tg, t(g_edge)), jgeo.edge_scatter(jg, g_edge))
    _close(tgeo.vol_scatter(tg, t(g_vol)), jgeo.vol_scatter(jg, g_vol))
    _close(tgeo.vol_interp(t(f)), jgeo.vol_interp(f))
    _close(tgeo.edge_interp(t(f)), jgeo.edge_interp(f))
    _close(tgeo.edge_interp_ext(tg, t(f)), jgeo.edge_interp_ext(jg, f))
    _close(tgeo.grad2d(tg, t(f)), jgeo.grad2d(jg, f))
    _close(tgeo.mass_apply(tg, t(f)), jgeo.mass_apply(jg, f))
    _close(tgeo.minv_apply(tg, t(f)), jgeo.minv_apply(jg, f))


@pytest.mark.parametrize("nl", [1, 4])
def test_layer_geometry_matches_jax(nl):
    rng = np.random.default_rng(nl)
    nt = 30
    b = 5.0 + 20.0 * rng.random((3, nt))
    eta0 = 0.1 * rng.standard_normal((3, nt))
    eta1 = 0.1 * rng.standard_normal((3, nt))
    eta0[0, :3] = -b[0, :3]                         # dry nodes hit h_min
    jvg, tvg = jext.VGrid(b=jnp.asarray(b), nl=nl), text.VGrid(
        b=torch.from_numpy(b), nl=nl)
    jv = jext.layer_geometry(jvg, jnp.asarray(eta0), 0.05)
    tv = text.layer_geometry(tvg, torch.from_numpy(eta0), 0.05)
    for f in ("H", "jz", "eta"):
        _close(getattr(tv, f), getattr(jv, f))
    _close(text.interface_z(tvg, tv), jext.interface_z(jvg, jv))
    _close(text.node_z(tvg, tv), jext.node_z(jvg, jv))
    _close(text.mesh_velocity(tvg, torch.from_numpy(eta0),
                              torch.from_numpy(eta1), 30.0),
           jext.mesh_velocity(jvg, jnp.asarray(eta0), jnp.asarray(eta1), 30.0))
    f3 = rng.standard_normal((2, nl, 6, nt))
    _close(text.vsum_dofs(torch.from_numpy(f3)), jext.vsum_dofs(f3))
    _close(text.expand2d(torch.from_numpy(b), nl), jext.expand2d(b, nl))


@pytest.mark.parametrize("kind", ["linear", "jackett"])
def test_rho_prime_matches_jax(kind):
    rng = np.random.default_rng(11)
    S = 30.0 + 8.0 * rng.random((3, 6, 20))
    T = 2.0 + 25.0 * rng.random((3, 6, 20))
    p = 100.0 * rng.random((3, 6, 20))
    t = torch.from_numpy
    _close(teos.rho_prime(t(S), t(T), t(p), kind),
           jeos.rho_prime(S, T, p, kind))
    with pytest.raises(ValueError):
        teos.rho_prime(t(S), t(T), t(p), "unknown")
