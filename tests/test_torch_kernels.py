"""The plain PyTorch versions of the port's four CUDA kernels (K1 solve_r,
K2 solve_w, K3 block_thomas, K4 lateral_flux) against the JAX package's
Pallas kernels in interpret mode, on the CPU.

The Pallas kernels take the cell layout (rows x columns, components folded
into extra columns); the port takes the stepper's SoA tensors.  Inputs are
made once with numpy and handed to both.  nt=200 is not a multiple of the
128-column cell, so the Pallas side pads a ragged tail.

Tolerance: float64 1e-12 * max(|ref|_inf, 1) and float32 1e-5 * max(...):
only the order of the sums differs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import geometry as jgeo  # noqa: E402
from repro.core import mesh2d as jmesh  # noqa: E402
from repro.core import vertical as jvert  # noqa: E402
from repro.kernels import column_solve as jcs  # noqa: E402
from repro.kernels import horizontal_flux as jhf  # noqa: E402
from repro.kernels import matrix_free as jmf  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import geometry as tgeo  # noqa: E402
from repro_torch.core import mesh2d as tmesh  # noqa: E402
from repro_torch.core import vertical as tvert  # noqa: E402
from repro_torch.kernels import column_solve, dispatch, horizontal_flux  # noqa: E402
from repro_torch.kernels import matrix_free, ops  # noqa: E402

NT = 200
DTYPES = {"f64": (np.float64, torch.float64, 1e-12),
          "f32": (np.float32, torch.float32, 1e-5)}


def _close(out, ref, tol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1.0)
    err = np.abs(out - ref).max()
    assert err <= tol * scale, (err, scale)


def _fold(x):
    """(K, a, b, nt) -> (a*b, K*nt): components as extra cell columns."""
    K, a, b, nt = x.shape
    return np.moveaxis(x, 0, 2).reshape(a * b, K * nt)


def _unfold(x, K, a, b):
    nt = x.shape[-1] // K
    return np.moveaxis(np.asarray(x).reshape(a, b, K, nt), 2, 0)


# ---------------------------------------------------------------------------
# K1 / K2: matrix-free sweeps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("nl", [1, 3])
@pytest.mark.parametrize("sweep", ["r", "w"])
def test_matrix_free_plain_vs_pallas(sweep, nl, dt):
    npd, td, tol = DTYPES[dt]
    rng = np.random.default_rng(nl)
    K = 2
    F = rng.standard_normal((K, nl, 6, NT)).astype(npd)
    bc = rng.standard_normal((K, 3, NT)).astype(npd)
    area = ((0.5 + rng.random(NT)) * 1e4).astype(npd)
    cell = jmf.solve_r_cell if sweep == "r" else jmf.solve_w_cell
    plain = (matrix_free.solve_r_plain if sweep == "r"
             else matrix_free.solve_w_plain)
    ref = cell(jnp.asarray(_fold(F)), jnp.asarray(np.tile(area, K)[None]),
               jnp.asarray(np.moveaxis(bc, 0, 1).reshape(3, K * NT)),
               interpret=True)
    t = torch.from_numpy
    out = plain(t(F), t(area), t(bc))
    assert out.dtype == td
    _close(out.numpy(), _unfold(ref, K, nl, 6), tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_solve_w_plain_zero_floor(dt):
    npd, _, tol = DTYPES[dt]
    rng = np.random.default_rng(5)
    F = rng.standard_normal((1, 3, 6, NT)).astype(npd)
    area = ((0.5 + rng.random(NT)) * 1e4).astype(npd)
    t = torch.from_numpy
    _close(matrix_free.solve_w_plain(t(F), t(area)).numpy(),
           matrix_free.solve_w_plain(t(F), t(area),
                                     torch.zeros((1, 3, NT), dtype=t(F).dtype)),
           0.0)


# ---------------------------------------------------------------------------
# K3: block-Thomas
# ---------------------------------------------------------------------------
def _blocks(rng, nl, npd):
    lo, dg, up = (0.1 * rng.standard_normal((nl, 6, 6, NT)) for _ in range(3))
    lo[0] = 0.0
    up[-1] = 0.0
    dg += 2.0 * np.eye(6)[None, :, :, None]
    return [x.astype(npd) for x in (lo, dg, up)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("nl,k", [(1, 2), (3, 2), (3, 4)])
def test_block_thomas_plain_vs_pallas(nl, k, dt):
    npd, _, tol = DTYPES[dt]
    rng = np.random.default_rng(10 * nl + k)
    lo, dg, up = _blocks(rng, nl, npd)
    rhs = rng.standard_normal((k, nl, 6, NT)).astype(npd)
    ref = jcs.block_thomas_cell(*map(jnp.asarray, (lo, dg, up)),
                                jnp.asarray(np.moveaxis(rhs, 0, 2)),
                                interpret=True)
    t = torch.from_numpy
    out = column_solve.block_thomas_plain(t(lo), t(dg), t(up), t(rhs))
    _close(out.numpy(), np.moveaxis(np.asarray(ref), 2, 0), tol)


# ---------------------------------------------------------------------------
# K4: lateral flux
# ---------------------------------------------------------------------------
def _lateral_inputs(rng, nl, k, npd):
    f = rng.standard_normal((k, nl, 6, NT)).astype(npd)
    fext = rng.standard_normal((k, nl, 3, 2, 2, NT)).astype(npd)
    speed = rng.standard_normal((nl, 2, 3, 2, NT)).astype(npd)
    elen = ((0.5 + rng.random((3, NT))) * 300.0).astype(npd)
    return f, fext, speed, elen


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("nl,k", [(1, 2), (3, 2), (3, 4)])
def test_lateral_flux_plain_vs_pallas(nl, k, dt):
    npd, _, tol = DTYPES[dt]
    rng = np.random.default_rng(100 + 10 * nl + k)
    f, fext, speed, elen = _lateral_inputs(rng, nl, k, npd)
    wq = (elen[:, None, :] * jgeo.W_GAUSS[:, None]).reshape(6, NT).astype(npd)
    ref = jhf.lateral_flux_cell(
        jnp.asarray(_fold(f)),
        jnp.asarray(_fold(fext.reshape(k, nl, 12, NT))),
        jnp.asarray(np.tile(speed.reshape(nl * 12, NT), (1, k))),
        jnp.asarray(np.tile(wq, (1, k))), interpret=True)
    t = torch.from_numpy
    out = horizontal_flux.lateral_flux_plain(t(f), t(fext), t(speed), t(elen))
    _close(out.numpy(), _unfold(ref, k, nl, 6), tol)


# ---------------------------------------------------------------------------
# ops: the stepper's entry points, plain backend vs JAX pallas_interpret
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def geoms():
    jg = jgeo.geom2d_from_mesh(
        jmesh.rect_mesh(10, 10, 1000.0, 800.0, jitter=0.2, seed=4),
        dtype=jnp.float64)
    tg = tgeo.geom2d_from_mesh(
        tmesh.rect_mesh(10, 10, 1000.0, 800.0, jitter=0.2, seed=4),
        dtype=torch.float64, device="cpu")
    assert tg.nt == NT
    return jg, tg


def test_ops_plain_vs_pallas_interpret(geoms):
    jg, tg = geoms
    rng = np.random.default_rng(21)
    nl = 3
    F = rng.standard_normal((2, nl, 6, NT))
    bc = rng.standard_normal((2, 3, NT))
    Fw = rng.standard_normal((nl, 6, NT))
    lo, dg, up = _blocks(rng, nl, np.float64)
    rhs = rng.standard_normal((2, nl, 6, NT))
    f, fext, speed, _ = _lateral_inputs(rng, nl, 4, np.float64)
    t = torch.from_numpy
    jb = "pallas_interpret"
    ops.reset_launches()
    _close(ops.solve_r(tg, t(F), t(bc), backend="plain").numpy(),
           jops.solve_r(jg, F, bc, backend=jb), 1e-12)
    _close(ops.solve_w(tg, t(Fw), backend="plain").numpy(),
           jops.solve_w(jg, Fw, backend=jb), 1e-12)
    _close(ops.block_thomas(tvert.Blocks(t(lo), t(dg), t(up)), t(rhs),
                            backend="plain").numpy(),
           jops.block_thomas(jvert.Blocks(lo, dg, up), rhs, backend=jb), 1e-12)
    _close(ops.lateral_flux_term(tg, t(f), t(fext), t(speed),
                                 backend="plain").numpy(),
           jops.lateral_flux_term(jg, f, fext, speed, backend=jb), 1e-12)
    assert dict(ops.LAUNCHES) == {(op, "plain"): 1 for op in (
        "solve_r", "solve_w", "block_thomas", "lateral_flux")}


def test_ops_ref_matches_plain(geoms):
    _, tg = geoms
    rng = np.random.default_rng(22)
    nl = 3
    t = lambda *s: torch.from_numpy(rng.standard_normal(s))
    F, bc = t(2, nl, 6, NT), t(2, 3, NT)
    blocks = tvert.Blocks(*map(torch.from_numpy, _blocks(rng, nl, np.float64)))
    rhs = t(2, nl, 6, NT)
    for name, call in (
            ("solve_r", lambda b: ops.solve_r(tg, F, bc, backend=b)),
            ("solve_w", lambda b: ops.solve_w(tg, F, bc, backend=b)),
            ("block_thomas", lambda b: ops.block_thomas(blocks, rhs, backend=b))):
        _close(call("ref").numpy(), call("plain").numpy(), 1e-12)


def test_backend_resolution_on_cpu(geoms):
    _, tg = geoms
    cpu = torch.device("cpu")
    assert dispatch.resolve("auto", cpu) is dispatch.Backend.PLAIN
    assert dispatch.resolve(None, cpu) is dispatch.Backend.PLAIN
    assert dispatch.resolve("ref", cpu) is dispatch.Backend.REF
    with pytest.raises(ValueError):
        dispatch.resolve("cuda", cpu)
    with pytest.raises(ValueError):
        dispatch.resolve("pallas", cpu)
    F = torch.zeros((1, 2, 6, NT), dtype=torch.float64)
    with pytest.raises(ValueError):
        ops.solve_w(tg, F, backend="cuda")
    with pytest.raises(ValueError):               # a kernel wrapper takes
        matrix_free.solve_w(F, tg.area)           # only CUDA tensors


def test_build_needs_the_source(monkeypatch, tmp_path):
    from repro_torch.kernels import cuda_lib
    monkeypatch.setattr(cuda_lib, "CSRC", tmp_path)     # holds no .cu file
    with pytest.raises(RuntimeError, match="source checkout"):
        cuda_lib.build()
