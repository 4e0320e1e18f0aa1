"""The port's scalar tridiagonal solve (plain K7) and the cell-layout entry
points of `kernels/ops.py` against the JAX package, on the CPU in float64.

The port's `ref` and `plain` backends are held against JAX `ref` and
`pallas_interpret` (the Pallas kernels in interpret mode), as
`tests/test_dispatch.py` holds the JAX backends against each other.
Tolerance: 1e-12 * max(|ref|_inf, 1) for the solves (the order of the sums
differs), bitwise for the layout copies.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import turbulence as jturb  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import tridiag as jtri  # noqa: E402
from repro_torch.core import turbulence as tturb  # noqa: E402
from repro_torch.kernels import ops, tridiag  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

TOL = 1e-12


def _close(out, ref, tol=TOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1.0)
    err = np.abs(out - ref).max()
    assert err <= tol * scale, (err, scale)


def _tridiag_system(rng, nl, C):
    """Diagonally dominant systems shaped like GLS's implicit diffusion
    (turbulence.diffusion_system): lo, up <= 0, d = 1 - lo - up."""
    lo = -5.0 * rng.random((nl, C))
    up = -5.0 * rng.random((nl, C))
    lo[0] = 0.0
    up[-1] = 0.0
    return lo, 1.0 - lo - up, up, rng.standard_normal((nl, C))


@pytest.mark.parametrize("C", [128, 256])
@pytest.mark.parametrize("nl", [1, 4, 16])
def test_tridiag_plain_vs_pallas(nl, C):
    sysm = _tridiag_system(np.random.default_rng(nl * C), nl, C)
    ref = jtri.tridiag_cell(*map(jnp.asarray, sysm), interpret=True)
    out = tridiag.tridiag_plain(*map(torch.from_numpy, sysm))
    _close(out.numpy(), ref)


@pytest.mark.parametrize("C", [1, 60, 129, 300])
def test_tridiag_plain_vs_thomas_ragged(C):
    """Any column count (the Pallas kernel needs C % 128 == 0); dl[0] and
    du[nl-1] are ignored."""
    rng = np.random.default_rng(C)
    lo, d, up, b = _tridiag_system(rng, 5, C)
    ref = jturb.thomas_solve(*map(jnp.asarray, (lo, d, up, b)))
    lo[0] = rng.standard_normal(C)
    up[-1] = rng.standard_normal(C)
    out = tridiag.tridiag_plain(*map(torch.from_numpy, (lo, d, up, b)))
    _close(out.numpy(), ref)


def test_gls_diffusion_system_solves_like_jax():
    """turbulence.diffusion_system, the system GLS hands to the solver."""
    rng = np.random.default_rng(3)
    nl, nt = 6, 40
    nu = 1e-3 * (1.0 + rng.random((nl, nt)))
    dz = 0.5 + rng.random((1, nt))
    f = rng.random((nl, nt))
    lo, d, up = tturb.diffusion_system(torch.from_numpy(nu),
                                       torch.from_numpy(dz), 30.0, 1.3)
    x = ops.tridiag(lo, d, up, torch.from_numpy(f), backend="plain")
    # the same system assembled by hand, solved by JAX
    nu_i = 0.5 * (nu[:-1] + nu[1:]) / 1.3
    w = nu_i / dz
    jlo = np.concatenate([np.zeros((1, nt)), -30.0 * w]) / dz
    jup = np.concatenate([-30.0 * w, np.zeros((1, nt))]) / dz
    ref = jturb.thomas_solve(*map(jnp.asarray, (jlo, 1.0 - jlo - jup, jup, f)))
    _close(x.numpy(), ref)


def _cell_inputs(rng, nl, C, k=2):
    F = rng.standard_normal((nl * 6, C))
    area = (0.5 + rng.random((1, C))) * 1e4
    bc = rng.standard_normal((3, C))
    lo, dg, up = (0.1 * rng.standard_normal((nl, 6, 6, C)) for _ in range(3))
    lo[0] = 0.0
    up[-1] = 0.0
    dg += 2.0 * np.eye(6)[None, :, :, None]
    b = rng.standard_normal((nl, 6, k, C))
    return F, area, bc, (lo, dg, up, b)


@pytest.mark.parametrize("tb,jb", [("plain", "pallas_interpret"),
                                   ("ref", "ref")])
def test_cell_ops_match_jax(tb, jb):
    rng = np.random.default_rng(7)
    nl, C = 3, 256
    F, area, bc, blk = _cell_inputs(rng, nl, C)
    tri = _tridiag_system(rng, nl, C)
    field = rng.standard_normal((nl, 6, 200))
    t = lambda *a: [torch.from_numpy(x) for x in a]
    metrics.reset()
    ops.reset_launches()
    _close(ops.tridiag(*t(*tri), backend=tb).numpy(),
           jops.tridiag(*tri, backend=jb))
    _close(ops.solve_r_cell(*t(F, area, bc), backend=tb).numpy(),
           jops.solve_r_cell(F, area, bc, backend=jb))
    _close(ops.solve_w_cell(*t(F, area, bc), backend=tb).numpy(),
           jops.solve_w_cell(F, area, bc, backend=jb))
    _close(ops.block_thomas_cell(*t(*blk), backend=tb).numpy(),
           jops.block_thomas_cell(*blk, backend=jb))
    c = ops.soa_to_cell(*t(field), backend=tb)
    np.testing.assert_array_equal(c.numpy(), jops.soa_to_cell(field, backend=jb))
    np.testing.assert_array_equal(ops.cell_to_soa(c, 200, backend=tb).numpy(),
                                  field)
    # one dispatch and one counted call per op, under the kernel's name
    snap = metrics.default().snapshot()["counter"]
    ran = ("tridiag", "solve_r_cell", "solve_w_cell", "block_thomas_cell",
           "soa_to_cell", "cell_to_soa")
    assert snap == {f"kernel_dispatch{{backend={tb},op={op}}}": 1.0
                    for op in ran}
    assert dict(ops.LAUNCHES) == {(ops.KERNEL[op], tb): 1 for op in ran}
    metrics.reset()


def test_cell_ops_ref_matches_plain():
    """The two CPU backends of the port against each other, at a ragged C."""
    rng = np.random.default_rng(8)
    F, area, bc, blk = (torch.from_numpy(x) if isinstance(x, np.ndarray)
                        else tuple(map(torch.from_numpy, x))
                        for x in _cell_inputs(rng, 4, 200))
    tri = [torch.from_numpy(x) for x in _tridiag_system(rng, 4, 200)]
    for call in (lambda b: ops.tridiag(*tri, backend=b),
                 lambda b: ops.solve_r_cell(F, area, bc, backend=b),
                 lambda b: ops.solve_w_cell(F, area, bc, backend=b),
                 lambda b: ops.block_thomas_cell(*blk, backend=b)):
        _close(call("ref").numpy(), call("plain").numpy())


def test_cell_ops_never_run_cuda_on_the_cpu():
    x = torch.zeros((2, 6, 130), dtype=torch.float64)
    a = torch.ones((3, 130), dtype=torch.float64)
    for call in (lambda: ops.soa_to_cell(x, backend="cuda"),
                 lambda: ops.cell_to_soa(torch.zeros((1, 12, 128)), 100,
                                         backend="cuda"),
                 lambda: ops.tridiag(a, a, a, a, backend="cuda"),
                 lambda: tridiag.tridiag(a, a, a, a)):
        with pytest.raises(ValueError):
            call()
    from repro_torch.kernels import cell_transpose
    with pytest.raises(ValueError):                 # a kernel wrapper takes
        cell_transpose.soa_to_cell(x)               # only CUDA tensors
