"""Rank side of the port's multi-rank CPU tests (not a test module itself).

`run_case(rank, n_ranks, case)` runs in each process that
`repro_torch.distributed.spawn.run` starts: it builds the rank's
`DistributedOcean` of the JAX distributed test's mesh
(`tests/test_distributed.py`: rect_mesh(16, 8) of 4 x 2 km, jitter 0.2,
seed 4, 20 m deep) on the CPU in float64, scatters the given global state
(or restores a checkpoint), takes the steps, optionally saves a checkpoint
on the way, and returns the gathered global state with the rank's facts.
It imports only the port, so the ranks never load JAX.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.core import mesh2d, stepper
from repro_torch.distributed import halo, ocean
from repro_torch.kernels import ops
from repro_torch.obs import metrics

NL, DT, M2D = 3, 24.0, 12


def mesh():
    return mesh2d.rect_mesh(16, 8, 4000.0, 2000.0, jitter=0.2, seed=4)


def config(period: int, backend: str = "auto") -> stepper.OceanConfig:
    return stepper.OceanConfig(nl=NL, dt=DT, m_2d=M2D, use_gls=True,
                               eos_kind="linear", halo_exchange_period=period,
                               backend=backend)


def run_case(rank: int, n_ranks: int, case: dict) -> dict:
    """case: period, steps, and either `state` (a global numpy state dict)
    or `restore` (a checkpoint directory); optional `save` (directory,
    step): the state after that many steps is saved there."""
    m = mesh()
    tr = halo.Transport()
    do = ocean.DistributedOcean(m, np.full((3, m.nt), 20.0),
                                config(case["period"]), rank, n_ranks, tr,
                                device="cpu")
    if "restore" in case:
        st = do.restore(Checkpointer(case["restore"]))
    else:
        st = do.scatter_state(convert.state_from_numpy(case["state"],
                                                       device="cpu"))
    step = do.make_step()
    ops.reset_launches()
    reg = metrics.default()
    shifts, nbytes = [], []
    for i in range(case["steps"]):
        s0 = reg.counter("halo.ppermute").value
        b0 = reg.counter("halo.bytes").value
        st = step(st)
        shifts.append(reg.counter("halo.ppermute").value - s0)
        nbytes.append(reg.counter("halo.bytes").value - b0)
        if "save" in case and i + 1 == case["save"][1]:
            do.save(Checkpointer(case["save"][0]), i + 1, st)
    out = do.gather_state(st)
    at0 = do.gather_state(st, dst=0)
    return dict(
        rank=rank, mode=tr.mode, n_own=do.spec.n_own, n_loc=do.spec.n_loc,
        offsets=do.tables.offsets,
        msg=[int(s.shape[-1]) for s in do.tables.send],
        shifts=shifts, bytes=nbytes, launches=dict(ops.LAUNCHES),
        backend=do.cfg.backend,
        devices=sorted({str(x.device) for x in
                        (st.ux, st.ext.eta, st.turb_k, do.geom.area)}),
        gauges={k: v for k, v in reg.snapshot()["gauge"].items()
                if k.startswith("distributed.")},
        state=convert.state_to_numpy(out),
        state_at_0=None if at0 is None else convert.state_to_numpy(at0))


def jax_case(period: int, steps: int):
    """The JAX distributed test's initial state (the eta bump and the T
    blob) and JAX's single-device `stepper.step` after `steps` steps with
    identity hooks, `backend="ref"` and the same `halo_exchange_period`,
    both as numpy state dicts.  Imports JAX: the test process calls it,
    never a rank."""
    import jax
    import jax.numpy as jnp
    from repro.core import geometry as jgeo
    from repro.core import mesh2d as jmesh
    from repro.core import stepper as jstep
    from repro.core.extrusion import VGrid as JVGrid

    m = jmesh.rect_mesh(16, 8, 4000.0, 2000.0, jitter=0.2, seed=4)
    geom = jgeo.geom2d_from_mesh(m, dtype=jnp.float64)
    vg = JVGrid(b=jnp.full((3, m.nt), 20.0, jnp.float64), nl=NL)
    cfg = jstep.OceanConfig(nl=NL, dt=DT, m_2d=M2D, use_gls=True,
                            eos_kind="linear", halo_exchange_period=period,
                            backend="ref")
    st = jstep.init_state(geom, vg, dtype=jnp.float64)
    eta0 = (0.05 * jnp.cos(jnp.pi * geom.node_x / 4000.0)
            * jnp.cos(jnp.pi * geom.node_y / 2000.0))
    Tf = 10.0 + 2.0 * jnp.exp(-((geom.node_x - 1000.0) ** 2
                                + (geom.node_y - 800.0) ** 2) / 5e5)
    T0 = jnp.broadcast_to(jnp.concatenate([Tf, Tf])[None], st.T.shape)
    st = dataclasses.replace(st, ext=dataclasses.replace(st.ext, eta=eta0),
                             T=T0)

    def to_np(s):
        d = {f.name: np.asarray(getattr(s, f.name))
             for f in dataclasses.fields(s) if f.name != "ext"}
        d["ext"] = {k: np.asarray(getattr(s.ext, k))
                    for k in ("eta", "qx", "qy")}
        return d

    step = jax.jit(lambda s: jstep.step(geom, vg, cfg, s,
                                        exchange2d=lambda e: e,
                                        exchange_field=lambda f: f))
    out = st
    for _ in range(steps):
        out = step(out)
    return to_np(st), to_np(out)


FIELDS = ("ux", "uy", "T", "S", "turb_k", "turb_eps", "nu_t", "kappa_t")


def gaps(ref: dict, got: dict) -> dict:
    """Each field's max difference over its own max (eta, qx, qy: absolute
    for eta, relative for the transports)."""
    out = {k: float(np.abs(ref[k] - got[k]).max()
                    / max(np.abs(ref[k]).max(), 1e-300)) for k in FIELDS}
    for k in ("qx", "qy"):
        a, b = ref["ext"][k], got["ext"][k]
        out[k] = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))
    out["eta_abs"] = float(np.abs(ref["ext"]["eta"] - got["ext"]["eta"]).max())
    return out


GLS = ("turb_k", "turb_eps", "nu_t", "kappa_t")


def assert_close(ref: dict, got: dict, rel: float = 1e-10,
                 eta_abs: float = 1e-12, gls_rel: float = None) -> dict:
    """Every field within `rel` of its own max (the GLS fields within
    `gls_rel`, default `rel`), eta within `eta_abs`; prints the gaps."""
    g = gaps(ref, got)
    print("gathered against the reference:",
          {k: f"{v:.3e}" for k, v in g.items()})
    for k, v in g.items():
        tol = (eta_abs if k == "eta_abs" else
               gls_rel if k in GLS and gls_rel is not None else rel)
        assert v <= tol, (k, v, tol)
    return g


def shifts_per_step(n_offsets: int, period: int, m_2d: int = M2D) -> int:
    """Closed form of halo.ppermute a step: over both stages, 5 field
    exchanges and 3 m_sub (period 0) or m_sub / period (period > 0)
    batched 2D exchanges, each one shift per ring offset; m_sub is
    max(m_2d // 2, 1) in stage 1 and m_2d in stage 2.  The tests' own
    copy, independent of `halo.shifts_per_step`, which it checks."""
    total = 0
    for m_sub in (max(m_2d // 2, 1), m_2d):
        total += 5 + (3 * m_sub if period == 0 else m_sub // period)
    return total * n_offsets


def bytes_per_step(msg: list, period: int, itemsize: int = 8,
                   m_2d: int = M2D, nl: int = NL) -> int:
    """Closed form of halo.bytes a step: ux, uy, T, S carry nl * 6 values
    a slot, eta 3, the stacked 2D state 3 x 3 (the tests' own copy of
    `halo.bytes_per_step`)."""
    n2d = shifts_per_step(1, period, m_2d) - 10
    return sum(msg) * itemsize * (2 * (4 * nl * 6 + 3) + 9 * n2d)


# ---------------------------------------------------------------------------
# ranks that fail: the spawn helper's deadline and error paths
# ---------------------------------------------------------------------------
def raise_on(rank: int, n_ranks: int, bad: int) -> int:
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank


def exit_hard(rank: int, n_ranks: int) -> int:
    import os
    if rank == n_ranks - 1:
        os._exit(3)
    return rank


def wait_for_nothing(rank: int, n_ranks: int) -> int:
    """Every rank waits for a message that no rank sends: a deadlocked
    exchange."""
    import torch.distributed as dist
    dist.recv(torch.zeros(1), src=(rank + 1) % n_ranks)
    return rank


# ---------------------------------------------------------------------------
# int8 gradient compression over the ranks (tests/test_torch_optim.py)
# ---------------------------------------------------------------------------
COMPRESS_RANKS, COMPRESS_STEPS, COMPRESS_WIDTH = 4, 20, 1000


def compress_grads(step: int) -> np.ndarray:
    """Every rank's gradient at ``step``: (COMPRESS_RANKS, COMPRESS_WIDTH)
    float32, growing with the step (the JAX substrate test's series)."""
    g = np.random.default_rng(0).normal(
        size=(COMPRESS_RANKS, COMPRESS_WIDTH)).astype(np.float32)
    return (g * np.float32(1.0 + 0.1 * step)).astype(np.float32)


def compress_steps(rank: int, n_ranks: int):
    """COMPRESS_STEPS compressed all-reduces of this rank's row, with error
    feedback; returns (means, error states), each (steps, width)."""
    from repro_torch.optim import compression
    e = {"w": torch.zeros(COMPRESS_WIDTH)}
    means, errs = [], []
    for step in range(COMPRESS_STEPS):
        g = {"w": torch.from_numpy(compress_grads(step)[rank])}
        m, e = compression.compressed_grad_psum(g, e)
        means.append(m["w"].numpy())
        errs.append(e["w"].numpy())
    return np.stack(means), np.stack(errs)
