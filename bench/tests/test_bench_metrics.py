"""The metric arithmetic on synthetic steps and traces: the p90 over all
steps, the busy union and idle gaps of overlapping device intervals, the
per-range sums, and the readers' silence where there is nothing to read."""
from __future__ import annotations

import statistics

import pytest

from bench import harness, roofline, spec
from bench.trace import DeviceOp, Trace

MS = 1_000_000


def op(name, start_ms, dur_ms, launched_ms, kernel=True):
    return DeviceOp(name, int(start_ms * MS), int(dur_ms * MS),
                    int(launched_ms * MS), kernel)


def synthetic() -> Trace:
    """Two steps of 10 ms wall: each with a burst range [1, 4] ms on the
    host holding two launches, a K3 call and an elementwise kernel;
    device intervals overlap in places."""
    ops, ranges = [], {"stage.external_burst": [], "stage.turbulence": []}
    for s in (0, 10):
        ranges["stage.external_burst"].append((int((s + 1) * MS),
                                               int((s + 4) * MS)))
        ranges["stage.turbulence"].append((int((s + 4) * MS),
                                           int((s + 9) * MS)))
        ops += [op("burst_a", s + 2, 1.0, s + 1.5),
                op("burst_b", s + 2.5, 1.0, s + 2),      # overlaps burst_a
                op("void block_thomas_kernel<double>", s + 5, 2.0, s + 4.5),
                op("elementwise", s + 8, 0.5, s + 7),
                op("Memcpy DtoD", s + 8.25, 0.5, -1, kernel=False)]
    return Trace(ops=ops, ranges=ranges, steps=2, window_s=0.020)


def ctx(tr, **kw):
    c = {"trace": tr, "launches": None, "nl": 16, "nt": 160_000,
         "dtype": "float64", "steps": 10, "wall_s": 5.0, "step_ms": [],
         "cell": {"flops_per_step": 67e9}}
    c.update(kw)
    return c


def test_p90_over_all_steps():
    steps = [float(v) for v in range(1, 21)]
    assert harness.p90(steps) == pytest.approx(18.1)
    assert harness.p90(steps) == statistics.quantiles(
        steps, n=10, method="inclusive")[8]
    assert harness.p90([7.0]) == 7.0


def test_busy_union_and_gaps():
    tr = synthetic()
    # per step: [2, 3.5] (two overlapping), [5, 7], [8, 8.75]
    assert tr.busy_ns() == 2 * int(4.25 * MS)
    gaps = tr.gaps()
    assert [g for _, g in gaps] == [int(1.5 * MS), MS, int(3.25 * MS),
                                    int(1.5 * MS), MS]
    assert tr.range_open_at(int(4.5 * MS)) == "stage.turbulence"
    assert tr.range_open_at(int(9.5 * MS)) == "outside the stages"


def read(name, c):
    return spec.reader(name)(c)


def test_per_range_sums():
    c = ctx(synthetic())
    assert read("launches_per_step", c) == 4
    assert read("burst_launches_per_step", c) == 2
    assert read("burst_device_ms_per_step", c) == pytest.approx(2.0)
    assert read("kernels_device_ms_per_step", c) == pytest.approx(2.0)
    assert read("dg_ops_device_ms_per_step", c) == pytest.approx(0.5)
    assert read("device_idle_share", c) == pytest.approx(100 * (1 - 8.5 / 20))
    assert read("step_mfu", c) == pytest.approx(100 * 67e9 / (0.5 * 67e12))
    assert read("step_ms_p90.hostbound",
                ctx(None, step_ms=[float(v) for v in range(1, 21)])) == \
        pytest.approx(18.1)


def test_breakdown_names_gaps_by_range():
    bd = harness._breakdown(synthetic())
    assert bd["device_ops"][0] == ["void block_thomas_kernel<double>", 0.004]
    gaps = dict(bd["idle_gaps"])
    # from 3.5, 13.5 in the burst; from 7, 8.75, 17 in the turbulence range
    assert gaps == pytest.approx({"stage.external_burst": 0.003,
                                  "stage.turbulence": 0.00525})


def test_roofline_reads_only_the_costed_calls():
    tr = synthetic()
    want = {k: len(v) * tr.steps for k, v in roofline.STEP_CALLS.items()}
    assert read("kernels_roofline", ctx(tr, launches=None)) is None
    assert read("kernels_roofline",
                ctx(tr, launches={**want, "tridiag": 7})) is None
    costs = roofline.step_costs(16, 160_000, "float64")
    bound = sum(roofline.bound_s(b, f, "float64") for b, f in costs.values())
    assert read("kernels_roofline", ctx(tr, launches=want)) == pytest.approx(
        100 * bound * 2 / 0.004)


def test_step_mfu_divides_by_the_cards():
    one = read("step_mfu", ctx(None))
    assert read("step_mfu", ctx(None, chips=1)) == one
    assert read("step_mfu", ctx(None, chips=4)) == pytest.approx(one / 4)


def test_halo_counters_per_step():
    c = ctx(None, steps=40, halo={"shifts": 40 * 300, "bytes": 40 * 2.5e6})
    assert read("halo_shifts_per_step", c) == 300
    assert read("halo_mb_per_step", c) == pytest.approx(2.5)
    assert read("halo_shifts_per_step",
                ctx(None, halo={"shifts": 0, "bytes": 0})) is None


def test_halo_device_time_reads_kernels_inside_the_exchanges():
    """Two exchanges a step on the host, [4.5, 5] and [7, 7.25] ms of each
    step: K3 (launched at 4.5) and the elementwise kernel (launched at 7)
    count; the memcpy (no launch) and the burst's kernels do not."""
    tr = synthetic()
    tr.ranges["halo.exchange"] = [(int((s + a) * MS), int((s + b) * MS))
                                  for s in (0, 10)
                                  for a, b in ((4.5, 5.0), (7.0, 7.25))]
    assert read("halo_device_ms_per_step", ctx(tr)) == pytest.approx(2.5)
    assert read("halo_device_ms_per_step", ctx(synthetic())) is None


def test_collective_kernels_are_the_exchange_s_alone():
    """An NCCL kernel waiting for its peer inside the burst (launched at
    3.5 ms of each step, running [3.6, 4.6]) and one outside it (launched
    at 9.2, running [9.3, 9.9]), both inside `halo.exchange` ranges: the
    exchange reads them; the burst, the DG operators and the device's busy
    time do not."""
    tr = synthetic()
    for s in (0, 10):
        tr.ops += [op("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage)",
                      s + 3.6, 1.0, s + 3.5),
                   op("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage)",
                      s + 9.3, 0.6, s + 9.2)]
    tr.ranges["halo.exchange"] = [(int((s + a) * MS), int((s + b) * MS))
                                  for s in (0, 10)
                                  for a, b in ((3.4, 3.55), (9.1, 9.25))]
    plain = synthetic()
    c = ctx(tr)
    assert tr.busy_ns() == plain.busy_ns()
    assert tr.gaps() == plain.gaps()
    for name in ("burst_device_ms_per_step", "dg_ops_device_ms_per_step",
                 "device_idle_share"):
        assert read(name, c) == read(name, ctx(plain))
    assert read("halo_device_ms_per_step", c) == pytest.approx(1.6)
    assert read("launches_per_step", c) == 6


@pytest.mark.parametrize("name", [m["name"] for m in spec.benchmark()["per_layer"]])
def test_readers_silent_without_a_trace(name):
    c = ctx(None, cell={"flops_per_step": None})
    assert read(name, c) is None
    empty = Trace(ops=[], ranges={}, steps=3, window_s=1.0)
    assert read(name, ctx(empty, cell={"flops_per_step": None})) is None
