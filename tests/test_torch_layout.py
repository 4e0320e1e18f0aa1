"""The port's cell layout (`core/layout.py`), the plain versions of its
cell-transpose kernels K5/K6 and the stepper's step-boundary transform
against the JAX package, on the CPU.

Everything here is a copy of the same numbers into another order, so every
comparison is bitwise.  The column counts are ragged (not multiples of the
128-wide cell), so the padding and slicing are exercised.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import geometry as jgeo  # noqa: E402
from repro.core import layout as jlay  # noqa: E402
from repro.core import stepper as jstep  # noqa: E402
from repro.kernels import cell_transpose as jct  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import layout  # noqa: E402
from repro_torch.core import stepper as tstep  # noqa: E402
from repro_torch.kernels import cell_transpose, ops  # noqa: E402

NTS = [1, 127, 129, 300]
NLS = [1, 3]


def _same(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    assert out.dtype == ref.dtype, (out.dtype, ref.dtype)
    np.testing.assert_array_equal(out, ref)


def _field(nt, nl, nn=6, lead=()):
    rng = np.random.default_rng(1000 * nl + nt)
    return rng.standard_normal((*lead, nl, nn, nt))


@pytest.mark.parametrize("nt", NTS)
@pytest.mark.parametrize("nl", NLS)
def test_layout_matches_jax(nl, nt):
    x = _field(nt, nl, lead=(2,))
    t = torch.from_numpy(x)
    assert layout.num_cells(nt) == jlay.num_cells(nt)
    _same(layout.pad_nt(t).numpy(), jlay.pad_nt(jnp.asarray(x)))
    c = layout.soa_to_cell(t)
    _same(c.numpy(), jlay.soa_to_cell(jnp.asarray(x)))
    _same(layout.cell_to_soa(c, nl, 6, nt).numpy(), x)
    _same(layout.cell_to_soa(c, nl, 6, nt).numpy(),
          jlay.cell_to_soa(jnp.asarray(c.numpy()), nl, 6, nt))

    blk = _field(nt, nl, nn=36).reshape(nl, 6, 6, nt)
    cb = layout.blocks_to_cell(torch.from_numpy(blk))
    _same(cb.numpy(), jlay.blocks_to_cell(jnp.asarray(blk)))
    _same(layout.cell_to_blocks(cb, nt).numpy(), blk)

    x2 = _field(nt, 1, nn=3)[0]                           # (3, nt)
    c2 = layout.soa2d_to_cell(torch.from_numpy(x2))
    _same(c2.numpy(), jlay.soa2d_to_cell(jnp.asarray(x2)))
    _same(layout.cell2d_to_soa(c2, nt).numpy(), x2)
    _same(layout.cell2d_to_soa(c2, nt).numpy(),
          jlay.cell2d_to_soa(jnp.asarray(c2.numpy()), nt))


def test_cell_to_soa_rejects_a_wrong_shape():
    c = torch.zeros((2, 18, 128))
    with pytest.raises(ValueError):
        layout.cell_to_soa(c, 4, 6, 200)
    with pytest.raises(ValueError):
        layout.cell_to_blocks(torch.zeros((1, 2, 6, 6, 64)), 10)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("nt", NTS)
@pytest.mark.parametrize("nl", NLS)
def test_cell_transpose_plain_vs_pallas(nl, nt, dt):
    """The plain K5/K6 against the Pallas kernels in interpret mode."""
    x = _field(nt, nl).astype(dt)
    c = cell_transpose.soa_to_cell_plain(torch.from_numpy(x))
    jc = jct.soa_to_cell(jnp.asarray(x), interpret=True)
    _same(c.numpy(), jc)
    back = cell_transpose.cell_to_soa_plain(c, nt)
    _same(back.numpy(), jct.cell_to_soa(jc, nt=nt, interpret=True))
    _same(back.numpy(), x)


def _state():
    """The JAX test state of tests/test_dispatch.py::_step_setup (nt=24,
    nl=3), carried across as numpy."""
    from repro.core import dg2d as jd2
    from repro.core import mesh2d as jmesh
    from repro.core.extrusion import VGrid
    m = jmesh.rect_mesh(4, 3, 2000.0, 1500.0, jitter=0.2, seed=3)
    geom = jgeo.geom2d_from_mesh(m, dtype=jnp.float64)
    vg = VGrid(b=jnp.full((3, m.nt), 20.0, jnp.float64), nl=3)
    st = jstep.init_state(geom, vg, dtype=jnp.float64)
    rng = np.random.default_rng(5)
    fields = {k: jnp.asarray(rng.standard_normal(st.T.shape))
              for k in ("ux", "uy", "T", "S")}
    eta = jnp.asarray(0.01 * rng.standard_normal(st.ext.eta.shape))
    st = dataclasses.replace(st, ext=jd2.State2D(eta, st.ext.qx, st.ext.qy),
                             **fields)
    d = {f.name: np.asarray(getattr(st, f.name))
         for f in dataclasses.fields(jstep.OceanState) if f.name != "ext"}
    d["ext"] = {k: np.asarray(getattr(st.ext, k)) for k in ("eta", "qx", "qy")}
    return st, d, m.nt


@pytest.mark.parametrize("tb,jb", [("plain", "pallas_interpret"),
                                   ("ref", "ref")])
def test_state_cell_roundtrip_matches_jax(tb, jb):
    jst, d, nt = _state()
    tst = convert.state_from_numpy(d, device="cpu")
    jcells = jstep.state_to_cell(jst, backend=jb)
    ops.reset_launches()
    cells = tstep.state_to_cell(tst, backend=tb)
    assert set(cells) == set(jcells) == {"ux", "uy", "T", "S"}
    for k in cells:
        assert cells[k].shape == (1, 3 * 6, 128)
        _same(cells[k].numpy(), jcells[k])
    back = tstep.state_from_cell(tst, cells, nt, backend=tb)
    jback = jstep.state_from_cell(jst, jcells, nt, backend=jb)
    for k in ("ux", "uy", "T", "S"):
        _same(getattr(back, k).numpy(), getattr(tst, k).numpy())
        _same(getattr(back, k).numpy(), jback.__getattribute__(k))
    assert back.ext is tst.ext and back.turb_k is tst.turb_k
    assert dict(ops.LAUNCHES) == {("soa_to_cell", tb): 4, ("cell_to_soa", tb): 4}
