"""The port's distributed step on 4 gloo ranks (one process each, CPU,
float64), communication-avoiding: `halo_exchange_period=2` with a 6-deep
halo, the 2D state exchanged once every 2 external sub-steps.

Case and tolerances: those of `tests/test_torch_distributed_ranks.py` (the
JAX distributed test's case, 3 steps, within 1e-10 of each field's max and
eta within 1e-12 of JAX's single-device step with identity hooks and the
same period, whose averaging order the port's burst follows).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_dist_ranks as R  # noqa: E402
from repro_torch.distributed import spawn  # noqa: E402

PERIOD, STEPS, RANKS = 2, 3, 4


@pytest.fixture(scope="module")
def jax_ref():
    return R.jax_case(PERIOD, STEPS)


@pytest.fixture(scope="module")
def run4(jax_ref):
    st0, _ = jax_ref
    return spawn.run(R.run_case, RANKS, timeout_s=300,
                     args=(dict(period=PERIOD, steps=STEPS, state=st0),))


def test_equivalence_comm_avoiding(jax_ref, run4):
    _, ref = jax_ref
    out = run4[0]["state"]
    R.assert_close(ref, out)
    assert np.abs(out["T"]).max() > 10.0             # the blob is alive
    for r in run4:
        assert r["gauges"]["distributed.halo_depth"] == 6
        assert r["n_loc"] > r["n_own"] + 1


def test_halo_counts_per_step(run4):
    """m_sub / 2 batched 2D exchanges a stage instead of 3 m_sub."""
    for r in run4:
        assert r["shifts"] == [R.shifts_per_step(len(r["offsets"]),
                                                 PERIOD)] * STEPS
        assert r["bytes"] == [R.bytes_per_step(r["msg"], PERIOD)] * STEPS
    assert R.shifts_per_step(3, 2) == ((5 + 3) + (5 + 6)) * 3
