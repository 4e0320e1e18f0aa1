"""The port's distributed step on 4 gloo ranks (one process each, CPU,
float64), per stage: `halo_exchange_period=0` with a 1-deep halo, the
paper's exchange before every 2D RK stage.

Case: the JAX distributed test's (`tests/test_distributed.py`): rect_mesh(16,
8) of 4 x 2 km, nt 256, nl 3, dt 24 s, m_2d 12, GLS, linear EOS, the eta
bump and the T blob.  Each rank runs `auto`, the kernels' plain versions
on the CPU.  The state gathered after 3 steps must be within 1e-10 of each
field's max, and eta within 1e-12, of JAX's single-device `stepper.step`
(backend "ref", identity hooks, the same period); a missed exchange shows
as an O(1e-3) error, not a rounding one.

The same run saves a checkpoint after step 2 (gathered onto rank 0 and
written there); a 2-rank run (rank 0 reads it and scatters) and a
single-device step restore it and take step 3.  Every spawn has a deadline
(`repro_torch.distributed.spawn`).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_dist_ranks as R  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.checkpoint import Checkpointer  # noqa: E402
from repro_torch.core import geometry, stepper  # noqa: E402
from repro_torch.core.extrusion import VGrid  # noqa: E402
from repro_torch.distributed import spawn  # noqa: E402

PERIOD, STEPS, RANKS = 0, 3, 4
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def jax_ref():
    return R.jax_case(PERIOD, STEPS)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharded"))


@pytest.fixture(scope="module")
def run4(jax_ref, ckpt_dir):
    st0, _ = jax_ref
    return spawn.run(R.run_case, RANKS, timeout_s=TIMEOUT_S,
                     args=(dict(period=PERIOD, steps=STEPS, state=st0,
                                save=(ckpt_dir, 2)),))


def test_equivalence_per_stage(jax_ref, run4):
    _, ref = jax_ref
    out = run4[0]["state"]
    R.assert_close(ref, out)
    assert np.abs(ref["T"]).max() > 10.0             # the blob is alive
    assert np.abs(out["T"]).max() > 10.0
    assert float(out["time"]) == STEPS * R.DT
    info = [(r["rank"], r["n_own"], r["n_loc"], r["offsets"], r["msg"])
            for r in run4]
    print("ranks (rank, n_own, n_loc, offsets, message sizes):", info)


def test_every_rank_holds_the_gathered_state(run4):
    for r in run4[1:]:
        for k in R.FIELDS:
            np.testing.assert_array_equal(r["state"][k], run4[0]["state"][k])
        for k in ("eta", "qx", "qy"):
            np.testing.assert_array_equal(r["state"]["ext"][k],
                                          run4[0]["state"]["ext"][k])


def test_gather_to_rank_0_only(run4):
    """`gather_state(st, dst=0)` (what a save uses) gives rank 0 the
    all-gathered state and every other rank None."""
    assert run4[0]["state_at_0"] is not None
    for k in R.FIELDS:
        np.testing.assert_array_equal(run4[0]["state_at_0"][k],
                                      run4[0]["state"][k])
    np.testing.assert_array_equal(run4[0]["state_at_0"]["ext"]["eta"],
                                  run4[0]["state"]["ext"]["eta"])
    assert [r["state_at_0"] for r in run4[1:]] == [None] * (RANKS - 1)


def test_halo_counts_per_step(run4):
    """halo.ppermute and halo.bytes a step equal their closed forms on
    every rank (eager: every executed shift counts)."""
    for r in run4:
        assert r["mode"] == "gloo-staged"
        assert r["shifts"] == [R.shifts_per_step(len(r["offsets"]),
                                                 PERIOD)] * STEPS
        assert r["bytes"] == [R.bytes_per_step(r["msg"], PERIOD)] * STEPS
    # (5 + 3 * 6) + (5 + 3 * 12) exchanges a step, one shift an offset
    assert R.shifts_per_step(2, 0) == 128


def test_ranks_run_the_kernel_path_on_their_device(run4):
    """Each rank's local step dispatches as the single-device step does:
    `auto` on CPU tensors is every kernel's plain version, each as often a
    step as on one device; the rank's tensors are on its device; the
    gauges describe the partition."""
    per_step = {"solve_r": 2, "solve_w": 2, "block_thomas": 2,
                "lateral_flux": 4, "tridiag": 4}
    for r in run4:
        assert r["backend"] == "auto"
        assert r["launches"] == {(k, "plain"): STEPS * n
                                 for k, n in per_step.items()}
        assert r["devices"] == ["cpu"]
        g = r["gauges"]
        assert g["distributed.n_parts"] == RANKS
        assert g["distributed.halo_depth"] == 1
        assert g["distributed.nt_local"] == r["n_loc"]
        assert g["distributed.halo_slots"] == sum(r["msg"])


def test_sharded_restore_onto_2_ranks_and_one_device(jax_ref, run4,
                                                     ckpt_dir):
    """4 ranks step 2 and save; 2 ranks restore and step 1 more: within
    1e-12 of the 4-rank 3 steps (the GLS fields within 1e-10: another cut
    rounds a few values at partition-boundary triangles one ulp otherwise,
    ~1e-16 of the max after one step, and the GLS closure amplifies that;
    the same spread lies between the 4-rank run and one device, and
    between JAX's sharded run and its single device) and within 1e-10 of
    JAX.  The same checkpoint restores into the single-device port
    step."""
    _, ref = jax_ref
    assert Checkpointer(ckpt_dir).steps() == [2]
    two = spawn.run(R.run_case, 2, timeout_s=TIMEOUT_S,
                    args=(dict(period=PERIOD, steps=1, restore=ckpt_dir),))
    assert two[0]["n_own"] == 128
    R.assert_close(run4[0]["state"], two[0]["state"], rel=1e-12,
                   gls_rel=1e-10)
    R.assert_close(ref, two[0]["state"])

    m = R.mesh()
    geom = geometry.geom2d_from_mesh(m, dtype=torch.float64, device="cpu")
    vg = VGrid(b=torch.full((3, m.nt), 20.0, dtype=torch.float64), nl=R.NL)
    st = Checkpointer(ckpt_dir).restore(stepper.init_state(geom, vg))
    assert st.ux.shape == (R.NL, 6, m.nt)
    np.testing.assert_allclose(float(st.time), 2 * R.DT)
    st = stepper.step(geom, vg, R.config(PERIOD, backend="ref"), st)
    R.assert_close(ref, convert.state_to_numpy(st))
