"""The external (2D) mode is sub-stepped explicitly, so its stable sub-step
shrinks with the thinnest triangle of the mesh.  On rect_mesh(40, 20) of
quickstart cells with jitter 0.25 (thinnest inradius 0.096 cell widths) the
quickstart's m_2d = 10 (3 s sub-steps in a 30 s step) grows without bound
from the third step on, in the JAX reference as in the port, while m_2d = 20
stays stable.  `repro_torch.quickstart.external_substeps` picks m_2d from
the thinnest triangle; on the smoke test's full-size mesh,
rect_mesh(400, 200) with jitter 0.2 (0.105 cell widths), it picks 20.

Both frameworks run the `ref` backend in float64, nl = 2, three steps.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import geometry as jgeo  # noqa: E402
from repro.core import mesh2d as jmesh  # noqa: E402
from repro.core import stepper as jstep  # noqa: E402
from repro.core.extrusion import VGrid as JVGrid  # noqa: E402
from repro_torch.core import geometry as tgeo  # noqa: E402
from repro_torch.core import mesh2d as tmesh  # noqa: E402
from repro_torch.core import stepper as tstep  # noqa: E402
from repro_torch.core.extrusion import VGrid  # noqa: E402
from repro_torch.quickstart import CELL_M, external_substeps  # noqa: E402

NX, NL, JITTER, STEPS = 40, 2, 0.25, 3


@pytest.mark.parametrize("nx,jitter,m_2d", [(12, 0.2, 10), (100, 0.2, 10),
                                             (400, 0.2, 20), (NX, JITTER, 20)])
def test_external_substeps(nx, jitter, m_2d):
    m = tmesh.rect_mesh(nx, nx // 2, nx * CELL_M, nx // 2 * CELL_M,
                        jitter=jitter, seed=1)
    assert external_substeps(m, 30.0) == m_2d


def _cfg(mod, m_2d, backend):
    return mod.OceanConfig(nl=NL, dt=30.0, m_2d=m_2d, eos_kind="linear",
                           use_gls=True, coriolis_f=1e-4, backend=backend)


def _jax_umax(m_2d):
    lx = NX * CELL_M
    m = jmesh.rect_mesh(NX, NX // 2, lx, NX // 2 * CELL_M, jitter=JITTER,
                        seed=1)
    geom = jgeo.geom2d_from_mesh(m, dtype=jnp.float64)
    vg = JVGrid(b=jnp.full((3, m.nt), 20.0, jnp.float64), nl=NL)
    st = jstep.init_state(geom, vg, dtype=jnp.float64)
    Tf = 10.0 + 4.0 * jnp.tanh((lx / 2 - geom.node_x) / 400.0)
    st = dataclasses.replace(st, T=jnp.broadcast_to(
        jnp.concatenate([Tf, Tf])[None], st.T.shape))
    cfg = _cfg(jstep, m_2d, "ref")
    step = jax.jit(lambda s: jstep.step(geom, vg, cfg, s))
    out = []
    for _ in range(STEPS):
        st = step(st)
        out.append(float(jnp.abs(st.ux).max()))
    return np.array(out)


def _port_umax(m_2d):
    lx = NX * CELL_M
    m = tmesh.rect_mesh(NX, NX // 2, lx, NX // 2 * CELL_M, jitter=JITTER,
                        seed=1)
    geom = tgeo.geom2d_from_mesh(m, dtype=torch.float64, device="cpu")
    vg = VGrid(b=torch.full((3, m.nt), 20.0, dtype=torch.float64), nl=NL)
    st = tstep.init_state(geom, vg)
    Tf = 10.0 + 4.0 * torch.tanh((lx / 2 - geom.node_x) / 400.0)
    st = dataclasses.replace(
        st, T=torch.cat([Tf, Tf])[None].expand(st.T.shape).contiguous())
    cfg = _cfg(tstep, m_2d, "ref")
    out = []
    for _ in range(STEPS):
        st = tstep.step(geom, vg, cfg, st)
        out.append(float(st.ux.abs().max()))
    return np.array(out)


@pytest.mark.parametrize("m_2d", [10, 20])
def test_external_substep_stability_matches_reference(m_2d):
    ref, port = _jax_umax(m_2d), _port_umax(m_2d)
    # the unstable growth amplifies rounding too: the port and JAX differ by
    # 1.7e-6 at the third m_2d = 10 step, by less than 1e-10 when stable
    np.testing.assert_allclose(port, ref, rtol=1e-4 if m_2d == 10 else 1e-10)
    growth = port[-1] / port[-2]
    if m_2d == 10:
        assert growth > 3.0, port          # unstable: 1.5e-2 -> 9.8e-2 m/s
    else:
        assert growth < 1.5, port          # stable: 1.5e-2 -> 1.9e-2 m/s
