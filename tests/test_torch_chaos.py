"""The port's chaos harness and fault-tolerant runners
(`repro_torch.runtime.chaos`, `repro_torch.runtime.fault_tolerance`,
`repro_torch.launch.sim_campaign`): the cases of the JAX package's
`tests/test_chaos.py` after its checkpointer's, on the CPU in float64.

Changes from the reference: the halo-payload site waits for the
distributed runtime (only its `halo_nan` kind is checked here); the three
8-device elastic restores become restores between devices (CPU to CPU
here; cuda to CPU and back in `tests/test_torch_gpu.py` and
`chip_smoke.py` phase 7).  Added: the fault-free campaign is deterministic
(two legs bitwise), a recovery resharded onto a device still ends
bitwise, a poison leaves the caller's state clean, and three checks
against JAX: the same plan poisons the same leaf and element (the logs
compare equal), the port's fault-free campaign ends within 1e-10 of
JAX's, and the dt ladder ends on JAX's rung, step count and time.
"""
import dataclasses
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import sim_campaign as jcampaign  # noqa: E402
from repro.obs import diagnostics as jdiag  # noqa: E402
from repro.runtime import chaos as jchaos  # noqa: E402
from repro.runtime import fault_tolerance as jft  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.chaos_smoke import bitwise_equal  # noqa: E402
from repro_torch.checkpoint.checkpoint import Checkpointer  # noqa: E402
from repro_torch.core import stepper  # noqa: E402
from repro_torch.launch import sim_campaign  # noqa: E402
from repro_torch.obs import diagnostics as obs_diag  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.runtime import chaos  # noqa: E402
from repro_torch.runtime.fault_tolerance import (LadderConfig,  # noqa: E402
                                                 RunnerConfig,
                                                 SimulationRunner,
                                                 TrainRunner)

F64 = torch.float64
STATE_FIELDS = ("ux", "uy", "T", "S", "turb_k", "turb_eps", "nu_t",
                "kappa_t", "time")


def demo_tree():
    return {"a": torch.arange(6.0, dtype=F64).reshape(2, 3),
            "b": {"c": torch.tensor(3),
                  "d": (torch.ones(4, dtype=F64), torch.zeros(2, dtype=F64))}}


def _np_state(st) -> dict:
    """A state of either framework as the dict `convert` takes."""
    d = {k: np.asarray(getattr(st, k)) for k in STATE_FIELDS}
    d["ext"] = {k: np.asarray(getattr(st.ext, k)) for k in ("eta", "qx", "qy")}
    return d


# ---------------------------------------------------------------------------
# chaos harness unit tests
# ---------------------------------------------------------------------------
def test_fault_validation_and_parse():
    with pytest.raises(ValueError, match="site"):
        chaos.Fault("nope", "poison_nan")
    with pytest.raises(ValueError, match="kind"):
        chaos.Fault("sim.state", "nope")
    f = chaos.parse_fault("poison_nan@sim.state:step=5,field=T,count=2")
    assert (f.site, f.kind, f.step, f.field, f.count) == \
        ("sim.state", "poison_nan", 5, "T", 2)
    f2 = chaos.parse_fault("stall@runner.step:seconds=0.01")
    assert f2.args == {"seconds": 0.01}
    f3 = chaos.parse_fault("halo_nan@halo.payload")
    assert (f3.site, f3.kind) == ("halo.payload", "halo_nan")
    f4 = chaos.parse_fault("reshard@runner.restore_shardings:device=cpu")
    assert f4.args == {"device": "cpu"}
    assert chaos.SITES == jchaos.SITES and chaos.KINDS == jchaos.KINDS


def test_site_is_identity_without_plan():
    x = {"a": torch.ones(3)}
    assert chaos.site("sim.state", x, step=0) is x


def test_poison_is_deterministic_and_field_targeted():
    st = {"T": torch.zeros((4, 5)), "S": torch.zeros((4, 5)),
          "turb_k": torch.zeros(3)}

    def poisoned(seed):
        plan = chaos.FaultPlan([chaos.Fault("sim.state", "poison_nan",
                                            step=2, field="T")], seed=seed)
        with chaos.active(plan):
            out = chaos.site("sim.state", st, step=2)
        return out, plan
    o1, p1 = poisoned(0)
    o2, _ = poisoned(0)
    assert bitwise_equal(o1, o2)                     # same seed, same cell
    assert int(o1["T"].isnan().sum()) == 1           # exactly one element
    assert not o1["S"].isnan().any()                 # exact-name match:
    assert not o1["turb_k"].isnan().any()            # T != turb_k
    assert p1.log and "T" in p1.log[0]["detail"]
    assert not st["T"].isnan().any()                 # caller's tree clean
    plan = chaos.FaultPlan([chaos.Fault("sim.state", "poison_nan",
                                        step=2, field="T")])
    with chaos.active(plan):
        out = chaos.site("sim.state", st, step=1)
    assert out is st and plan.log == []              # nothing fires off-step


@pytest.mark.parametrize("kind,seed,step,field", [
    ("poison_nan", 0, 5, "T"), ("poison_inf", 0, 5, "ux"),
    ("poison_nan", 3, 2, None), ("poison_inf", 7, 9, None),
    ("poison_nan", 1, 4, "eta")])
def test_same_plan_poisons_the_same_element_as_jax(kind, seed, step, field):
    """The campaign state of both frameworks under one plan: the same leaf
    and element go bad, the logs compare equal, the rest is untouched."""
    jst = jcampaign.build_case(nx=4, ny=3, nl=4).state
    tst = convert.state_from_numpy(_np_state(jst), device="cpu")
    outs, logs = [], []
    for mod, st in ((jchaos, jst), (chaos, tst)):
        plan = mod.FaultPlan([mod.Fault("sim.state", kind, step=step,
                                        field=field)], seed=seed)
        with mod.active(plan):
            outs.append(_np_state(mod.site("sim.state", st, step=step)))
        logs.append(plan.log)
    assert logs[0] == logs[1] and len(logs[0]) == 1
    for k in STATE_FIELDS:
        np.testing.assert_array_equal(outs[1][k], outs[0][k])
    for k in ("eta", "qx", "qy"):
        np.testing.assert_array_equal(outs[1]["ext"][k], outs[0]["ext"][k])
    assert not tst.T.isnan().any() and not tst.ux.isinf().any()


def test_halo_nan_fills_the_payload():
    plan = chaos.FaultPlan([chaos.Fault("halo.payload", "halo_nan")])
    buf = torch.arange(4.0)
    with chaos.active(plan):
        out = chaos.site("halo.payload", buf, offset=2)
    assert out.isnan().all() and not buf.isnan().any()
    assert plan.log[0]["detail"] == "halo payload -> NaN (offset=2)"


def test_corrupt_leaf_and_latest_injectors(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=5)
    ck.save(1, demo_tree(), blocking=True)
    plan = chaos.FaultPlan([
        chaos.Fault("checkpoint.saved", "truncate", step=2, field="a"),
        chaos.Fault("checkpoint.saved", "stale_latest", step=3)])
    with chaos.active(plan):
        ck.save(2, demo_tree(), blocking=True)
        ck.save(3, demo_tree(), blocking=True)
    assert any("checksum" in p or "unreadable" in p for p in ck.verify(2))
    assert open(tmp_path / "latest").read().strip() == "step_000000001"
    assert ck.latest_step() == 3
    assert 2 not in ck.intact_steps()


# ---------------------------------------------------------------------------
# restores between devices (the reference's elastic restores)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("devices", ["cpu", {"x": "cpu"}, None])
def test_restore_between_devices(tmp_path, devices):
    """Saved from one device, restored onto the one named (here both are
    the CPU; cuda <-> CPU runs on the card): the full array, bitwise."""
    ck = Checkpointer(str(tmp_path))
    x = torch.arange(64.0, dtype=F64).reshape(8, 8)
    ck.save(7, {"x": x}, blocking=True)
    assert ck.verify(7) == []
    assert ck.manifest(7)["leaves"]["x"]["shape"] == [8, 8]
    out = ck.restore({"x": torch.zeros((8, 8), dtype=F64)}, devices=devices)
    assert out["x"].device == torch.device("cpu")
    assert torch.equal(out["x"], x)


def test_reshard_chaos_site(tmp_path):
    """The runner.restore_shardings site swaps the restore device at
    recovery time, bitwise-preserving."""
    ck = Checkpointer(str(tmp_path))
    x = torch.arange(12.0, dtype=F64).reshape(3, 4)
    ck.save(2, {"x": x}, blocking=True)
    cfg = RunnerConfig(checkpoint_dir=str(tmp_path), emit_metrics=False)
    # configured onto the "meta" device: only the swap lands it on the CPU
    runner = SimulationRunner(lambda c: None, object(), cfg,
                              state_devices="meta")
    plan = chaos.FaultPlan([chaos.Fault("runner.restore_shardings",
                                        "reshard", args={"device": "cpu"})])
    with chaos.active(plan):
        state, step = runner._recover({"x": torch.zeros((3, 4), dtype=F64)},
                                      None, 0)
    assert step == 2 and plan.log[0]["kind"] == "reshard"
    assert state["x"].device == torch.device("cpu")
    assert torch.equal(state["x"], x)


# ---------------------------------------------------------------------------
# runner semantics
# ---------------------------------------------------------------------------
class _Dataset:
    def batch_at(self, step):
        return {"x": torch.tensor(float(step), dtype=F64)}


def test_train_runner_cold_restore_from_start(tmp_path):
    """A failure BEFORE the first checkpoint restarts from the caller's
    start snapshot (counted as a cold restore)."""
    seen = []
    failed = {"done": False}

    def step_fn(state, batch):
        s = int(state["step"])
        seen.append(s)
        if s == 2 and not failed["done"]:
            failed["done"] = True
            raise RuntimeError("injected failure before first checkpoint")
        return ({"step": state["step"] + 1,
                 "acc": state["acc"] + batch["x"]}, {"loss": 1.0})

    cfg = RunnerConfig(checkpoint_dir=str(tmp_path), checkpoint_every=100,
                       max_retries=2, emit_metrics=False, backoff_base_s=0.0)
    runner = TrainRunner(step_fn, _Dataset(), cfg)
    out = runner.run({"step": torch.tensor(0),
                      "acc": torch.tensor(0.0, dtype=F64)},
                     n_steps=4, resume=False)
    assert runner.stats["cold_restores"] == 1
    assert seen == [0, 1, 2, 0, 1, 2, 3]        # restarted from scratch
    assert int(out["step"]) == 4
    assert float(out["acc"]) == sum(range(4))   # deterministic re-run


def test_signal_handlers_restored_after_run(tmp_path):
    sentinel = lambda signum, frame: None       # noqa: E731
    prev_term = signal.getsignal(signal.SIGTERM)
    prev_int = signal.getsignal(signal.SIGINT)
    try:
        signal.signal(signal.SIGTERM, sentinel)
        cfg = RunnerConfig(checkpoint_dir=str(tmp_path), emit_metrics=False)
        runner = TrainRunner(lambda s, b: (s, {"loss": 1.0}), _Dataset(), cfg)
        runner.run({"s": torch.tensor(0)}, n_steps=2, resume=False)
        assert signal.getsignal(signal.SIGTERM) is sentinel
        assert signal.getsignal(signal.SIGINT) is prev_int
        bad = TrainRunner(lambda s, b: (_ for _ in ()).throw(
            RuntimeError("boom")), _Dataset(),
            dataclasses.replace(cfg, max_retries=0, backoff_base_s=0.0))
        with pytest.raises(RuntimeError, match="boom"):
            bad.run({"s": torch.tensor(0)}, n_steps=2, resume=False)
        assert signal.getsignal(signal.SIGTERM) is sentinel
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        signal.signal(signal.SIGINT, prev_int)


def test_runner_save_failure_is_retried_not_silent(tmp_path):
    cfg = RunnerConfig(checkpoint_dir=str(tmp_path), checkpoint_every=2,
                       max_retries=2, emit_metrics=False, backoff_base_s=0.0)
    runner = TrainRunner(
        lambda s, b: ({"step": s["step"] + 1}, {"loss": 1.0}), _Dataset(), cfg)
    plan = chaos.FaultPlan([chaos.Fault("checkpoint.write", "io_error",
                                        step=2)])
    with chaos.active(plan):
        out = runner.run({"step": torch.tensor(0)}, n_steps=6, resume=False)
    assert int(out["step"]) == 6
    assert runner.stats["ckpt_failures"] == 1
    assert runner.ckpt.latest_step() == 6       # cadence recovered


# ---------------------------------------------------------------------------
# SimulationRunner: synthetic ladder mechanics (fast, no ocean step)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _ToyCfg:
    dt: float = 10.0


def test_sim_ladder_engages_and_rewidens(tmp_path):
    def factory(cfg):
        def fn(state):
            n = int(state["n"])
            if cfg.dt == 10.0 and n < 2:
                raise RuntimeError(f"synthetic blow-up at n={n}")
            return {"n": state["n"] + 1}, {"nonfinite": False, "cfl_2d": 0.2}
        return fn

    cfg = RunnerConfig(checkpoint_dir=str(tmp_path), checkpoint_every=2,
                       max_retries=3, emit_metrics=False, backoff_base_s=0.0)
    ladder = LadderConfig(dt_factor=0.5, max_rungs=2, recover_steps=3,
                          cfl_ok=0.8)
    runner = SimulationRunner(factory, _ToyCfg(), cfg, ladder=ladder)
    out = runner.run({"n": torch.tensor(0)}, n_steps=6, resume=False)
    assert int(out["n"]) == 6
    assert runner.stats["retries"] == 2
    assert runner.stats["cold_restores"] == 2
    assert runner.stats["ladder_engagements"] == 1
    assert runner.stats["ladder_transitions"] == 2   # down once, up once
    assert runner.rung == 0                          # re-widened


def test_sim_ladder_disabled_is_blind_retry(tmp_path):
    def factory(cfg):
        def fn(state):
            if cfg.dt == 10.0:
                raise RuntimeError("deterministic blow-up")
            return {"n": state["n"] + 1}, {"nonfinite": False}
        return fn

    cfg = RunnerConfig(checkpoint_dir=str(tmp_path), max_retries=3,
                       emit_metrics=False, backoff_base_s=0.0)
    runner = SimulationRunner(factory, _ToyCfg(), cfg,
                              ladder=LadderConfig(max_rungs=0))
    with pytest.raises(RuntimeError, match="deterministic blow-up"):
        runner.run({"n": torch.tensor(0)}, n_steps=4, resume=False)
    assert runner.stats["retries"] == 4          # exhausted, no escalation


def test_with_recovery_scales_dt_and_viscosity():
    cfg = stepper.OceanConfig(dt=60.0, m_2d=20, nu_v_bg=1e-4, kappa_v_bg=1e-5)
    r = cfg.with_recovery(dt_factor=0.5, visc_factor=10.0)
    assert r.dt == 30.0 and r.m_2d == 20        # dt_2d halves consistently
    assert r.nu_v_bg == pytest.approx(1e-3)
    assert r.kappa_v_bg == pytest.approx(1e-4)
    assert cfg.dt == 60.0                        # original untouched


# ---------------------------------------------------------------------------
# the ocean chaos matrix (bitwise recovery) + the CFL blow-up ladder
# ---------------------------------------------------------------------------
N_STEPS = 6


@pytest.fixture(scope="module")
def ocean_case():
    return sim_campaign.build_case(nx=4, ny=3, nl=4, device="cpu")


def _run_ocean(case, tmp_path, name, plan, resume=False, n=N_STEPS, **kw):
    cfg = RunnerConfig(checkpoint_dir=str(tmp_path / name),
                       checkpoint_every=2, max_retries=3,
                       emit_metrics=False, backoff_base_s=0.0)
    return sim_campaign.run_campaign(
        case, n, cfg, policy=sim_campaign.default_policy(), plan=plan,
        resume=resume, **kw)


@pytest.fixture(scope="module")
def ocean_baseline(ocean_case, tmp_path_factory):
    out, _ = _run_ocean(ocean_case, tmp_path_factory.mktemp("base"),
                        "baseline", plan=None)
    return out


def test_fault_free_campaign_is_deterministic(ocean_case, ocean_baseline,
                                              tmp_path):
    out, runner = _run_ocean(ocean_case, tmp_path, "again", plan=None)
    assert runner.stats["steps"] == N_STEPS and runner.stats["retries"] == 0
    assert bitwise_equal(out, ocean_baseline)
    assert float(out.time) == N_STEPS * ocean_case.cfg.dt


def test_chaos_matrix_nan_poison_bitwise(ocean_case, ocean_baseline,
                                         tmp_path):
    plan = chaos.FaultPlan([chaos.Fault("sim.state", "poison_nan",
                                        step=N_STEPS - 1, field="T")])
    out, runner = _run_ocean(ocean_case, tmp_path, "nan", plan)
    assert len(plan.log) == 1
    assert runner.stats["retries"] == 1
    assert runner.rung == 0                      # transient: no degradation
    assert bitwise_equal(out, ocean_baseline)


def test_chaos_matrix_corrupt_checkpoint_bitwise(ocean_case, ocean_baseline,
                                                 tmp_path):
    metrics.reset()
    plan = chaos.FaultPlan(
        [chaos.Fault("checkpoint.saved", "truncate", step=4),
         chaos.Fault("sim.state", "poison_inf", step=N_STEPS - 1,
                     field="ux")])
    out, runner = _run_ocean(ocean_case, tmp_path, "corrupt", plan)
    skipped = metrics.default().snapshot()["counter"].get(
        "checkpoint.corrupt_skipped", 0)
    assert skipped >= 1                          # fell back past step 4
    assert bitwise_equal(out, ocean_baseline)
    metrics.reset()


def test_chaos_matrix_preemption_bitwise(ocean_case, ocean_baseline,
                                         tmp_path):
    plan = chaos.FaultPlan([chaos.Fault("runner.step", "preempt",
                                        step=N_STEPS - 2)])
    out1, runner1 = _run_ocean(ocean_case, tmp_path, "preempt", plan)
    assert runner1.stats["preempted"]
    assert runner1.ckpt.latest_step() == N_STEPS - 2   # blocking save
    out, runner2 = _run_ocean(ocean_case, tmp_path, "preempt", plan=None,
                              resume=True)
    assert runner2.stats["steps"] == 2           # only the preempted tail
    assert bitwise_equal(out, ocean_baseline)


def test_chaos_matrix_save_thread_failure_bitwise(ocean_case, ocean_baseline,
                                                  tmp_path):
    plan = chaos.FaultPlan([chaos.Fault("checkpoint.write", "io_error",
                                        step=2)])
    out, runner = _run_ocean(ocean_case, tmp_path, "savefail", plan)
    assert runner.stats["ckpt_failures"] == 1
    assert runner.stats["retries"] == 0          # never lost sim progress
    assert bitwise_equal(out, ocean_baseline)


def test_chaos_matrix_resharded_recovery_bitwise(ocean_case, ocean_baseline,
                                                 tmp_path):
    """A recovery whose restore device is swapped (``reshard``) steps on
    the restored state's device and ends bitwise (CPU to CPU here)."""
    plan = chaos.FaultPlan(
        [chaos.Fault("sim.state", "poison_nan", step=N_STEPS - 1, field="S"),
         chaos.Fault("runner.restore_shardings", "reshard",
                     args={"device": "cpu"})])
    out, runner = _run_ocean(ocean_case, tmp_path, "reshard", plan)
    assert [r["kind"] for r in plan.log] == ["poison_nan", "reshard"]
    assert runner.stats["retries"] == 1
    assert bitwise_equal(out, ocean_baseline)


def test_cfl_blowup_recovers_via_dt_ladder(tmp_path):
    """Forced deterministic CFL blow-up (dt=80 on this mesh diverges in one
    step): blind restore-and-retry fails; the dt ladder halves dt, finishes
    the run, and reports the engagement through obs.metrics."""
    metrics.reset()
    blow = sim_campaign.build_case(nx=4, ny=3, nl=4, dt=80.0, device="cpu")
    cfg = lambda d: RunnerConfig(checkpoint_dir=str(tmp_path / d),  # noqa: E731
                                 checkpoint_every=2, max_retries=3,
                                 backoff_base_s=0.0)
    with pytest.raises(obs_diag.MonitorHalt):
        sim_campaign.run_campaign(blow, 4, cfg("blind"),
                                  ladder=LadderConfig(max_rungs=0),
                                  policy=sim_campaign.default_policy(),
                                  resume=False)
    ladder = LadderConfig(dt_factor=0.5, max_rungs=2, recover_steps=64)
    out, runner = sim_campaign.run_campaign(
        blow, 4, cfg("ladder"), ladder=ladder,
        policy=sim_campaign.default_policy(), resume=False)
    assert runner.stats["ladder_engagements"] >= 1
    assert runner.rung == 1
    assert runner.stats["steps"] == 4
    assert float(out.time) == pytest.approx(4 * 40.0)    # ran at dt/2
    snap = metrics.default().snapshot()["counter"]
    assert snap.get("sim.ladder.transitions{direction=down}", 0) >= 1
    assert snap.get("runner.retries", 0) == 4 + 2        # blind 4, ladder 2
    d = obs_diag.to_dict(obs_diag.compute(blow.geom, blow.vg,
                                          blow.cfg.with_recovery(0.5), out))
    assert not d["nonfinite"] and d["cfl_2d"] < 1.0
    metrics.reset()


# ---------------------------------------------------------------------------
# against JAX: the fault-free campaign and the ladder
# ---------------------------------------------------------------------------
def _jax_runner(case, tmp_path, name, ladder=None):
    cfg = jft.RunnerConfig(checkpoint_dir=str(tmp_path / name),
                           checkpoint_every=2, max_retries=3,
                           emit_metrics=False, backoff_base_s=0.0)
    fns = {}

    def factory(c):
        if c.dt not in fns:
            fns[c.dt] = jax.jit(lambda s: jdiag.step_with_diagnostics(
                case.geom, case.vg, c, s))
        return fns[c.dt]
    return jft.SimulationRunner(factory, case.cfg, cfg, ladder=ladder,
                                policy=jcampaign.default_policy())


def test_fault_free_campaign_matches_jax(tmp_path):
    """JAX's campaign and the port's from the same state (carried across),
    N_STEPS steps each: every field within 1e-10 of its own maximum."""
    jcase = jcampaign.build_case(nx=4, ny=3, nl=4)
    jout = _jax_runner(jcase, tmp_path, "jax").run(jcase.state, N_STEPS,
                                                    resume=False)
    tcase = sim_campaign.build_case(nx=4, ny=3, nl=4, device="cpu")
    tcase = dataclasses.replace(tcase, state=convert.state_from_numpy(
        _np_state(jcase.state), device="cpu"))
    tout, runner = _run_ocean(tcase, tmp_path, "port", plan=None)
    a, b = _np_state(jout), _np_state(tout)
    for k in STATE_FIELDS[:-1]:
        err = np.abs(a[k] - b[k]).max() / max(np.abs(a[k]).max(), 1e-30)
        assert err <= 1e-10, (k, err)
    for k in ("eta", "qx", "qy"):
        err = np.abs(a["ext"][k] - b["ext"][k]).max() / np.abs(a["ext"][k]).max()
        assert err <= 1e-10, (k, err)
    assert float(b["time"]) == float(a["time"]) == N_STEPS * 5.0
    assert np.abs(b["ux"]).max() > 1e-6


def test_dt_ladder_matches_jax(tmp_path):
    """The same blow-up under the same ladder in both frameworks: the same
    retries, rung, step count, time and ladder transitions."""
    ladder = dict(dt_factor=0.5, max_rungs=2, recover_steps=64)
    jcase = jcampaign.build_case(nx=4, ny=3, nl=4, dt=80.0)
    jr = _jax_runner(jcase, tmp_path, "jax", jft.LadderConfig(**ladder))
    jout = jr.run(jcase.state, 4, resume=False)
    tcase = sim_campaign.build_case(nx=4, ny=3, nl=4, dt=80.0, device="cpu")
    tout, tr = _run_ocean(tcase, tmp_path, "port", plan=None, n=4,
                          ladder=LadderConfig(**ladder))
    keys = ("steps", "retries", "cold_restores", "ladder_engagements",
            "ladder_transitions")
    assert {k: tr.stats[k] for k in keys} == {k: jr.stats[k] for k in keys}
    assert tr.rung == jr.rung == 1
    assert float(tout.time) == float(jout.time) == 160.0
