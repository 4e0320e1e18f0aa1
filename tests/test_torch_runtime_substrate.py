"""The port's data pipeline (`repro_torch.data.pipeline`), its training
runner with crash recovery and NaN-retry
(`repro_torch.runtime.fault_tolerance.TrainRunner`) and its timing helper
(`repro_torch.benchmarks.common`): the cases of the JAX package's
`tests/test_substrate.py` (token batches, forcing windows, checkpointed
resume and crash recovery) and of `tests/test_obs.py` (NaN diagnostics
answered by restore-and-retry, `time_fn`), with the token batches, the
forcing windows and the tidal provider held against JAX's on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.benchmarks.common import Timing, block_tree, time_fn  # noqa: E402
from repro_torch.data.pipeline import (ForcingWindow, TokenDataset,  # noqa: E402
                                       interp_forcing,
                                       tidal_forcing_provider)
from repro_torch.launch import sim_campaign  # noqa: E402
from repro_torch.obs import diagnostics as obs_diag  # noqa: E402
from repro_torch.runtime.fault_tolerance import RunnerConfig, TrainRunner  # noqa: E402

F64 = torch.float64


# ---------------------------------------------------------------------------
# token batches
# ---------------------------------------------------------------------------
def test_token_dataset_deterministic_resume():
    ds = TokenDataset(vocab=100, seq_len=16, global_batch=4, seed=3,
                      device="cpu")
    b5, b5b = ds.batch_at(5), ds.batch_at(5)
    assert torch.equal(b5["tokens"], b5b["tokens"])
    b = TokenDataset(vocab=100, seq_len=16, global_batch=4, seed=3,
                     device="cpu").batch_at(0)
    assert b["tokens"].shape == (4, 16) and b["labels"].shape == (4, 16)
    assert b["tokens"].dtype == torch.int32
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])  # shifted
    it = iter(ds)
    assert torch.equal(next(it)["tokens"], ds.batch_at(0)["tokens"])
    assert torch.equal(next(it)["labels"], ds.batch_at(1)["labels"])


@pytest.mark.parametrize("source", ["synthetic", "file"])
@pytest.mark.parametrize("step", [0, 7])
def test_token_batches_equal_jax(tmp_path, source, step):
    kw = dict(vocab=50, seq_len=12, global_batch=3, seed=2)
    if source == "file":
        path = str(tmp_path / "tokens.bin")
        np.random.default_rng(0).integers(0, 50, 400).astype(
            np.uint16).tofile(path)
        jds = jpipe.TokenDataset.from_file(path, 50, 12, 3)
        tds = TokenDataset.from_file(path, 50, 12, 3, device="cpu")
    else:
        jds = jpipe.TokenDataset(**kw)
        tds = TokenDataset(**kw, device="cpu")
    jb, tb = jds.batch_at(step), tds.batch_at(step)
    for k in ("tokens", "labels"):
        assert tb[k].numpy().dtype == np.asarray(jb[k]).dtype
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


# ---------------------------------------------------------------------------
# forcing windows
# ---------------------------------------------------------------------------
def test_forcing_window_interpolation():
    calls = []

    def provider(k):
        calls.append(k)
        return {"f": torch.full((3,), float(k), dtype=F64)}
    fw = ForcingWindow(provider, dt_window=3600.0, prefetch=False,
                       device="cpu")
    f0, f1, t0, t1 = fw.at(1800.0)
    v = interp_forcing(f0["f"], f1["f"], t0, t1, torch.tensor(1800.0))
    torch.testing.assert_close(v, torch.full((3,), 0.5, dtype=F64))
    f0, f1, t0, t1 = fw.at(2.5 * 3600.0)                 # two windows on
    v = interp_forcing(f0["f"], f1["f"], t0, t1, 2.5 * 3600.0)
    torch.testing.assert_close(v, torch.full((3,), 2.5, dtype=F64))
    assert calls == [0, 1, 2, 3]


@pytest.mark.parametrize("prefetch", [False, True])
def test_forcing_windows_equal_jax(prefetch):
    """The tidal provider's windows, walked in both frameworks (the port's
    with its prefetch thread): the same interpolated values."""
    from repro.core import geometry as jgeo
    from repro.core import mesh2d as jmesh
    case = sim_campaign.build_case(nx=4, ny=3, nl=2, device="cpu")
    jm = jmesh.rect_mesh(4, 3, 2000.0, 1500.0, jitter=0.2, seed=3)
    jg = jgeo.geom2d_from_mesh(jm, dtype=jnp.float64)
    period = 44712.0
    jfw = jpipe.ForcingWindow(jpipe.tidal_forcing_provider(jg, 0.8, period),
                              dt_window=period / 12.0, prefetch=False)
    tfw = ForcingWindow(tidal_forcing_provider(case.geom, 0.8, period),
                        dt_window=period / 12.0, prefetch=prefetch,
                        device="cpu")
    for t in (0.0, 1000.0, 5000.0, 9000.0, 30000.0):
        jf0, jf1, jt0, jt1 = jfw.at(t)
        tf0, tf1, tt0, tt1 = tfw.at(t)
        assert (tt0, tt1) == (jt0, jt1)
        jv = jpipe.interp_forcing(jf0["eta_open"], jf1["eta_open"], jt0, jt1,
                                  jnp.asarray(t))
        tv = interp_forcing(tf0["eta_open"], tf1["eta_open"], tt0, tt1, t)
        assert tv.shape == (3, case.geom.nt)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                   atol=1e-15)


# ---------------------------------------------------------------------------
# the training runner: resume, crash recovery, NaN-retry
# ---------------------------------------------------------------------------
def test_runner_resume_and_crash_recovery(tmp_path):
    ds = TokenDataset(vocab=10, seq_len=4, global_batch=2, seed=0,
                      device="cpu")
    fail_at = {7}

    def step_fn(state, batch):
        step = int(state["step"])
        if step in fail_at:
            fail_at.clear()          # fail once
            raise RuntimeError("injected device failure")
        return ({"step": state["step"] + 1,
                 "acc": state["acc"] + float(batch["tokens"].sum())},
                {"loss": 1.0})

    cfg = RunnerConfig(checkpoint_dir=str(tmp_path), checkpoint_every=2,
                       max_retries=2, backoff_base_s=0.0)
    runner = TrainRunner(step_fn, ds, cfg)
    state = {"step": torch.tensor(0), "acc": torch.tensor(0.0, dtype=F64)}
    out = runner.run(state, n_steps=10, resume=False)
    assert int(out["step"]) == 10
    assert runner.stats["retries"] == 1
    ref = sum(float(ds.batch_at(s)["tokens"].sum()) for s in range(10))
    assert abs(float(out["acc"]) - ref) < 1e-6
    # a second run resumes from the last checkpoint and does nothing more
    again = TrainRunner(step_fn, ds, cfg)
    out2 = again.run({"step": torch.tensor(0),
                      "acc": torch.tensor(0.0, dtype=F64)}, n_steps=10)
    assert again.stats["steps"] == 0 and int(out2["step"]) == 10
    assert float(out2["acc"]) == float(out["acc"])


class _CountingDataset:
    def batch_at(self, step):
        return {"x": torch.tensor(float(step), dtype=F64)}


def test_runner_retries_on_nonfinite_diagnostics(tmp_path):
    failed = {"done": False}

    def step_fn(state, batch):
        s = int(state["step"])
        new = {"step": state["step"] + 1, "acc": state["acc"] + batch["x"]}
        diag = {"nonfinite": False, "bad_field_name": None, "bad_cell": -1}
        if s == 5 and not failed["done"]:
            failed["done"] = True   # fail exactly once, first time at step 5
            diag = {"nonfinite": True, "bad_field_name": "T", "bad_cell": 7}
        return new, {"loss": 1.0, "diagnostics": diag}

    cfg = RunnerConfig(checkpoint_dir=str(tmp_path), checkpoint_every=2,
                       max_retries=2, emit_metrics=False)
    runner = TrainRunner(step_fn, _CountingDataset(), cfg)
    out = runner.run({"step": torch.tensor(0),
                      "acc": torch.tensor(0.0, dtype=F64)},
                     n_steps=8, resume=False)
    assert int(out["step"]) == 8
    assert runner.stats["retries"] == 1
    assert float(out["acc"]) == sum(range(8))   # restored to step 4, re-ran


def test_runner_diag_failure_exhausts_retries(tmp_path):
    def step_fn(state, batch):
        return state, {"loss": 1.0,
                       "diagnostics": {"nonfinite": True,
                                       "bad_field_name": "eta",
                                       "bad_cell": 0}}

    cfg = RunnerConfig(checkpoint_dir=str(tmp_path), checkpoint_every=100,
                       max_retries=1, emit_metrics=False)
    runner = TrainRunner(step_fn, _CountingDataset(), cfg)
    with pytest.raises(FloatingPointError, match="field=eta"):
        runner.run({"step": torch.tensor(0)}, n_steps=3, resume=False)


def test_runner_accepts_diagnostics_bundle(tmp_path):
    """The duck-typed check also reads the Diagnostics dataclass itself."""
    case = sim_campaign.build_case(nx=4, ny=3, nl=4, device="cpu")
    T = case.state.T.clone()
    T[0, 0, 3] = float("nan")
    bad = dataclasses.replace(case.state, T=T)
    diag = obs_diag.compute(case.geom, case.vg, case.cfg, bad)

    def step_fn(state, batch):
        return state, {"loss": 1.0, "diagnostics": diag}

    cfg = RunnerConfig(checkpoint_dir=str(tmp_path), max_retries=0,
                       emit_metrics=False)
    runner = TrainRunner(step_fn, _CountingDataset(), cfg)
    with pytest.raises(FloatingPointError, match="field=T, cell=3"):
        runner.run({"s": torch.tensor(0)}, n_steps=1, resume=False)


def test_runner_nonfinite_loss_is_a_failure(tmp_path):
    cfg = RunnerConfig(checkpoint_dir=str(tmp_path), max_retries=0,
                       emit_metrics=False)
    runner = TrainRunner(lambda s, b: (s, {"loss": torch.tensor(float("inf"))}),
                         _CountingDataset(), cfg)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        runner.run({"s": torch.tensor(0)}, n_steps=1, resume=False)


# ---------------------------------------------------------------------------
# benchmarks/common.time_fn
# ---------------------------------------------------------------------------
def test_time_fn_blocks_trees_and_reports_percentiles():
    def fn(x):
        return {"a": x * 2, "b": [x + 1, None, "label"], "t": (x,)}

    t = time_fn(fn, torch.arange(8.0), warmup=1, iters=5)
    assert isinstance(t, float) and isinstance(t, Timing)
    assert t.min <= t.p50 <= t.p90 and t.n == 5
    assert t * 1e6 > 0.0  # float arithmetic still works
    assert set(t.stats()) == {"p50", "p90", "min", "mean", "n"}
    out = {"x": torch.ones(2), "s": "label", "n": None}
    assert block_tree(out) is out
    with pytest.raises(ValueError, match="reduce"):
        time_fn(fn, torch.ones(1), reduce="mean")


# ---------------------------------------------------------------------------
# entry points: the card unless the CPU is asked for
# ---------------------------------------------------------------------------
def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from repro_torch import chaos_smoke
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_campaign.main(["--steps", "2", "--ckpt", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos_smoke.main([])
    assert not any(tmp_path.iterdir())              # nothing ran


def test_sim_campaign_main_on_the_cpu(tmp_path, capsys):
    """A resumable campaign with a poisoned step, as the CLI runs it."""
    from repro_torch.obs import metrics
    args = ["--device", "cpu", "--steps", "6", "--ckpt-every", "2",
            "--nx", "4", "--ny", "3", "--ckpt", str(tmp_path / "ck"),
            "--metrics", str(tmp_path / "m.jsonl"),
            "--fault", "poison_nan@sim.state:step=5,field=T"]
    try:
        assert sim_campaign.main(args) == 0
    finally:
        metrics.reset()
    out = capsys.readouterr().out
    assert "steps=7 retries=1" in out and "t=30.0s device=cpu" in out
    assert "'kind': 'poison_nan'" in out
    assert (tmp_path / "m.jsonl").stat().st_size > 0
