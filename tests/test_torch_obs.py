"""The port's flight recorder (`repro_torch.obs`) on the CPU: the metrics
registry and schema, the dispatch counter, the physics diagnostics
(conservation to roundoff, NaN localisation, monitor policy) and the obs
smoke; held against the JAX package where both compute the same thing.

Mirrors `tests/test_obs.py:40-94` and `:113-195`.  Diagnostics of the same
state agree with JAX's `diagnostics.compute` within 1e-10 relative (sums
in another order); the port's JSONL validates under JAX's schema.
"""
import dataclasses
import json
import math
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dg2d as jd2  # noqa: E402
from repro.core import geometry as jgeo  # noqa: E402
from repro.core import mesh2d as jmesh  # noqa: E402
from repro.core import stepper as jstep  # noqa: E402
from repro.core.extrusion import VGrid as JVGrid  # noqa: E402
from repro.obs import diagnostics as jdiag  # noqa: E402
from repro.obs import schema as jschema  # noqa: E402
from repro_torch import convert, obs_smoke, profile_step  # noqa: E402
from repro_torch.core import stepper  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.obs import diagnostics as obs_diag  # noqa: E402
from repro_torch.obs import metrics, schema, trace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def wave():
    """The standing-wave case of the obs smoke on the port, on the CPU."""
    return obs_smoke.setup(torch.device("cpu"))


# ---------------------------------------------------------------------------
# metrics registry + schema
# ---------------------------------------------------------------------------
def test_registry_roundtrip_jsonl(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    reg = metrics.Registry(sink=metrics.JsonlSink(path))
    reg.counter("kernel_dispatch", op="solve_r", backend="ref").inc(3)
    reg.gauge("runner.step_time_ema_s").set(0.125)
    h = reg.histogram("stage_time_us", stage="imex.stage1")
    for v in (10.0, 20.0, 30.0):
        h.observe(v)
    reg.event("monitor.violation", {"rule": "cfl_2d", "value": 1.5}, step=2)
    reg.diagnostics("physics", {"volume": 1.0, "nonfinite": False,
                                "eta_max": float("nan")}, step=2)
    reg.flush(step=3)
    reg.close()

    for validate in (schema.validate_file, jschema.validate_file):
        n_ok, errors = validate(path)
        assert errors == [], errors
        assert n_ok == 5  # event + diagnostics + counter + gauge + histogram
    recs = [json.loads(line) for line in open(path)]
    diag = next(r for r in recs if r["kind"] == "diagnostics")
    assert diag["value"]["eta_max"] is None  # NaN sanitised to null
    hist = next(r for r in recs if r["kind"] == "histogram")
    assert hist["value"]["p50"] == 20.0 and hist["value"]["count"] == 3
    snap = reg.snapshot()
    assert snap["counter"]["kernel_dispatch{backend=ref,op=solve_r}"] == 3.0


def test_schema_rejects_malformed():
    with pytest.raises(schema.SchemaError):
        schema.validate_record({"ts": 0.0, "kind": "bogus", "name": "x"})
    with pytest.raises(schema.SchemaError):
        schema.validate_record({"ts": 0.0, "kind": "counter", "name": "x",
                                "value": -1})
    with pytest.raises(schema.SchemaError):
        schema.validate_record({"kind": "gauge", "name": "x", "value": 1})
    # strict JSON: bare NaN literals are schema violations, not valid JSON
    n_ok, errors = schema.validate_lines(
        ['{"ts": 1.0, "kind": "gauge", "name": "g", "value": NaN}'])
    assert n_ok == 0 and len(errors) == 1


def test_dispatch_counter_counts_calls():
    """Eager PyTorch: every call of an op counts one dispatch (JAX counts
    one per traced program)."""
    metrics.reset()
    a = torch.ones((4, 128), dtype=torch.float64)
    ops.reset_launches()
    ops.tridiag(a, 4.0 * a, a, a)
    ops.tridiag(a, 4.0 * a, a, a)
    snap = metrics.default().snapshot()["counter"]
    assert snap == {"kernel_dispatch{backend=plain,op=tridiag}": 2.0}
    assert dict(ops.LAUNCHES) == {("tridiag", "plain"): 2}
    metrics.reset()


def test_annotate_names_profiler_ranges(wave):
    """The stepper's and the ops' ranges reach a profiler trace, and
    profile_step's stage table finds every stage range of one step."""
    geom, vg, cfg, st = wave
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.annotate("obs.test"):
            stepper.step(geom, vg, cfg, st)
    names = {e.name for e in prof.events()}
    assert {"obs.test", "imex.stage1", "kops.solve_r.plain",
            "kops.block_thomas.plain"} <= names
    rows = {r["scope"]: r for r in profile_step.stage_table(prof.events())}
    assert list(rows) == list(profile_step.SCOPES)
    calls = {k: r["calls"] for k, r in rows.items()}
    assert calls.pop("imex.stage1") == calls.pop("imex.stage2") == 1
    assert calls.pop("stage.turbulence_final") == 1     # explicit stage only
    assert set(calls.values()) == {2}
    assert all(r["launches"] == 0 for r in rows.values())   # no card


RECORDER_ONLY = {"ocean.step", "burst.substep", "burst.rhs",
                 "vertical.mass_solve3d"}


def _fields(st):
    out = {f.name: getattr(st, f.name) for f in dataclasses.fields(st)
           if f.name != "ext"}
    return {**out, **{f.name: getattr(st.ext, f.name)
                      for f in dataclasses.fields(st.ext)}}


def test_spans_off_record_nothing_and_open_no_profiler_range(wave,
                                                             monkeypatch):
    """With recording off and no profiler, a step records no span, counts
    no sync and never opens a record_function; open_ranges still names the
    open spans."""
    geom, vg, cfg, st = wave
    trace.drain()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    stepper.step(geom, vg, cfg, st)
    assert trace.spans() == [] and trace.sync_counts() == {}
    with trace.annotate("stage.a"), trace.annotate("b.c", profiler=False):
        assert trace.open_ranges() == ("stage.a", "b.c")
    assert trace.open_ranges() == ()


def test_spans_of_one_step_nest_and_change_no_bit(wave):
    """Recording on: one ocean.step, m/2 + m burst sub-steps and three RHS
    evaluations each, every span under the step with its parent as in the
    stepper, self time its duration less its children's; the state is
    bitwise the one of a step without recording."""
    geom, vg, cfg, st = wave
    plain = stepper.step(geom, vg, cfg, st)
    with trace.recording():
        recorded = stepper.step(geom, vg, cfg, st)
    spans = trace.drain()
    assert trace.spans() == []
    assert len(_fields(plain)) == 12
    for name, value in _fields(plain).items():
        assert torch.equal(value, _fields(recorded)[name]), name

    names = [s.name for s in spans]
    m = cfg.m_2d
    assert names[0] == "ocean.step" and names.count("ocean.step") == 1
    assert names.count("burst.substep") == m // 2 + m
    assert names.count("burst.rhs") == 3 * (m // 2 + m)
    assert names.count("vertical.mass_solve3d") == 2
    parent_of = {"imex.stage1": "ocean.step", "imex.stage2": "ocean.step",
                 "burst.substep": "stage.external_burst",
                 "burst.rhs": "burst.substep"}
    for s in spans:
        assert s.step == 0 and s.end_ns >= s.start_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        if s.name in parent_of:
            assert spans[s.parent].name == parent_of[s.name]
        if s.name.startswith("stage."):
            assert spans[s.parent].name.startswith("imex.")
        if s.name.startswith("kops.") or s.name == "vertical.mass_solve3d":
            assert spans[s.parent].name.startswith("stage.")
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    for i, (s, own) in enumerate(zip(spans, trace.self_ns(spans))):
        cover = sum(k.end_ns - k.start_ns for k in kids.get(i, ()))
        assert own == s.end_ns - s.start_ns - cover


def test_self_time_counts_overlapping_children_once():
    S = trace.Span
    spans = [S("a", 0, 100, -1, 0, 0), S("b", 10, 40, 0, 0, 0),
             S("c", 30, 60, 0, 0, 0), S("d", 90, 120, 0, 0, 0),
             S("e", 35, 38, 1, 0, 0), S("f", 50, None, 0, 0, 0)]
    assert trace.self_ns(spans) == [100 - 50 - 10, 30 - 3, 30, 30, 3, 0]


def test_span_clock_is_the_profilers(wave):
    """Under a CPU profiler, the stage spans' starts lie within 200 us of
    the profiler's own records of those ranges: the median over the
    step's 19, since a thread the OS deschedules between the two stamps
    reads one span tens of ms off (the perf counter itself is ~1.8e9 s
    from the profiler's clock)."""
    geom, vg, cfg, st = wave
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.annotate("obs.warm"):
            pass
        with trace.recording():
            stepper.step(geom, vg, cfg, st)
    spans = trace.drain()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("stage.")]
    starts = {}
    for e in events:
        starts.setdefault(e.name(), []).append(e.start_ns())
    mine = [s for s in spans if s.name.startswith("stage.")]
    assert len(mine) == len(events) >= 19
    off = sorted(min(abs(t - s.start_ns) for t in starts[s.name])
                 for s in mine)
    assert off[len(off) // 2] < 200_000, off
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "imex.stage1" in names and not names & RECORDER_ONLY


def test_syncs_count_under_the_innermost_span():
    """PyTorch's sync warnings count against the innermost open span, every
    one of them; other warnings pass through; nothing counts once off."""
    text = trace.SYNC_WARNING + " (Triggered internally at Copy.cpp:1.)"
    with trace.recording():
        with trace.annotate("ocean.step", profiler=False):
            with trace.annotate("vertical.mass_solve3d", profiler=False):
                for _ in range(2):
                    warnings.warn(text)
            warnings.warn(text)
        warnings.warn(text)
        with pytest.warns(UserWarning, match="other"):
            warnings.warn("other")
    with pytest.warns(UserWarning, match=trace.SYNC_WARNING):
        warnings.warn(text)
    assert trace.sync_counts() == {"vertical.mass_solve3d": 2,
                                   "ocean.step": 1, trace.NO_SPAN: 1}
    assert [s.syncs for s in trace.drain()] == [1, 2]
    assert trace.sync_counts() == {}


def test_recorded_spans_pop_only_the_nvtx_ranges_they_pushed(monkeypatch):
    """A recorded span inside which CUDA first initialises pushed no NVTX
    range, so it pops none; one opened after pops its own."""
    stack, ready = [], [False]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: ready[0])
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", stack.append)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", stack.pop)
    with trace.recording():
        with trace.annotate("stage.a"):
            ready[0] = True
            with trace.annotate("stage.b"):
                assert stack == ["stage.b"]
            with trace.annotate("burst.c", profiler=False):
                assert stack == []
        assert stack == []
    trace.drain()


def test_trace_session_is_opt_in(tmp_path, monkeypatch):
    monkeypatch.delenv(trace.ENV_TRACE, raising=False)
    with trace.trace_session(run_dir=str(tmp_path / "off")) as d:
        assert d is None
    monkeypatch.setenv(trace.ENV_TRACE, "1")
    run = tmp_path / "on"
    with trace.trace_session(run_dir=str(run)) as d:
        with trace.annotate("obs.session"):
            torch.ones(3).sum()
    assert d == str(run)
    events = json.loads((run / trace.TRACE_FILE).read_text())["traceEvents"]
    assert any(e.get("name") == "obs.session" for e in events)


# ---------------------------------------------------------------------------
# physics diagnostics
# ---------------------------------------------------------------------------
def test_conservation_standing_wave_20_steps(wave):
    """Volume and tracer mass conserved to f64 roundoff over 20 steps."""
    geom, vg, cfg, st = wave
    st, diag = obs_diag.step_with_diagnostics(geom, vg, cfg, st)
    d0 = obs_diag.to_dict(diag)
    for _ in range(19):
        st, diag = obs_diag.step_with_diagnostics(geom, vg, cfg, st)
    d = obs_diag.to_dict(diag)
    assert abs(d["volume"] - d0["volume"]) / d0["volume"] < 1e-12
    assert abs(d["mass_T"] - d0["mass_T"]) / d0["mass_T"] < 1e-12
    assert abs(d["mass_S"] - d0["mass_S"]) / d0["mass_S"] < 1e-12
    assert not d["nonfinite"] and d["bad_cell"] == -1
    assert 0.0 < d["cfl_2d"] < 1.0
    assert 0.0 < d["eta_max"] <= 0.06  # wave oscillates within initial amp
    assert d["time"] == 20 * cfg.dt


def test_nan_localizer_pinpoints_injected_cell(wave):
    geom, vg, cfg, st = wave
    bad_cell = 7
    T = st.T.clone()
    T[2, 4, bad_cell] = float("nan")
    d = obs_diag.to_dict(obs_diag.compute(geom, vg, cfg,
                                          dataclasses.replace(st, T=T)))
    assert d["nonfinite"]
    assert d["bad_field_name"] == "T"
    assert d["bad_cell"] == bad_cell
    # priority order: a bad eta in a later cell wins over the bad T
    eta = st.ext.eta.clone()
    eta[0, 11] = float("inf")
    st2 = dataclasses.replace(st, T=T,
                              ext=dataclasses.replace(st.ext, eta=eta))
    d2 = obs_diag.to_dict(obs_diag.compute(geom, vg, cfg, st2))
    assert d2["bad_field_name"] == "eta" and d2["bad_cell"] == 11


def test_monitor_policy_warn_and_halt(tmp_path, wave):
    geom, vg, cfg, st = wave
    diag = obs_diag.compute(geom, vg, cfg, st)

    ok = obs_diag.MonitorPolicy(cfl_max=1.0, on_violation="halt")
    assert ok.check(diag) == []

    path = str(tmp_path / "m.jsonl")
    reg = metrics.Registry(sink=metrics.JsonlSink(path))
    warn = obs_diag.MonitorPolicy(cfl_max=1e-6, eta_max=1e-3,
                                  on_violation="warn")
    with pytest.warns(RuntimeWarning, match="cfl_2d"):
        v = warn.check(diag, step=0, registry=reg)
    assert {x["rule"] for x in v} == {"cfl_2d", "eta_max"}
    reg.close()
    n_ok, errors = schema.validate_file(path)
    assert errors == [] and n_ok == 3  # 1 diagnostics + 2 violation events

    halt = obs_diag.MonitorPolicy(cfl_max=1e-6, on_violation="halt")
    with pytest.raises(obs_diag.MonitorHalt) as ei:
        halt.check(diag)
    assert ei.value.violations[0]["rule"] == "cfl_2d"

    # tracer bounds + drift vs first-check reference
    drift = obs_diag.MonitorPolicy(
        cfl_max=None, tracer_bounds={"T": (9.9, 10.1)},
        volume_drift_max=1e-12, on_violation="silent")
    assert drift.check(diag) == []          # captures reference
    bigger = dataclasses.replace(diag, volume=diag.volume * 1.01,
                                 T_max=torch.tensor(11.0))
    v = drift.check(bigger)
    assert {x["rule"] for x in v} == {"T_max", "volume_drift"}


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def _jax_wave():
    m = jmesh.rect_mesh(6, 5, 2000.0, 1500.0, jitter=0.2, seed=3)
    geom = jgeo.geom2d_from_mesh(m, dtype=jnp.float64)
    vg = JVGrid(b=jnp.full((3, m.nt), 20.0, jnp.float64), nl=4)
    st = jstep.init_state(geom, vg, dtype=jnp.float64)
    eta = (0.05 * jnp.cos(jnp.pi * geom.node_x / 2000.0)).astype(jnp.float64)
    st = dataclasses.replace(st, ext=jd2.State2D(eta, st.ext.qx, st.ext.qy))
    return geom, vg, jstep.OceanConfig(dt=5.0, nl=4, m_2d=6), st


def _to_numpy(st):
    """A writable numpy copy of a JAX OceanState."""
    d = {f.name: np.array(getattr(st, f.name))
         for f in dataclasses.fields(jstep.OceanState) if f.name != "ext"}
    d["ext"] = {k: np.array(getattr(st.ext, k)) for k in ("eta", "qx", "qy")}
    return d


def _from_numpy(d):
    ext = jd2.State2D(*(jnp.asarray(d["ext"][k]) for k in ("eta", "qx", "qy")))
    return jstep.OceanState(ext=ext, **{k: jnp.asarray(v) for k, v in d.items()
                                        if k != "ext"})


@pytest.fixture(scope="module")
def jax_stepped():
    """The standing wave after one JAX step, and the JAX case."""
    import jax
    jg, jvg, jcfg, jst = _jax_wave()
    st1 = jax.jit(lambda s: jstep.step(jg, jvg, jcfg, s))(jst)
    return jg, jvg, jcfg, _to_numpy(st1)


@pytest.mark.parametrize("poison", [None, "S", "qy"])
def test_compute_matches_jax(wave, jax_stepped, poison):
    """The port's diagnostics of a JAX-stepped state (carried across) equal
    JAX's to 1e-10 relative, with the same NaN localisation."""
    geom, vg, cfg, _ = wave
    jg, jvg, jcfg, d = jax_stepped
    d = {k: ({kk: vv.copy() for kk, vv in v.items()} if k == "ext"
             else v.copy()) for k, v in d.items()}
    if poison == "S":
        d["S"][1, 3, 17] = np.nan
    elif poison == "qy":
        d["ext"]["qy"][2, 40] = -np.inf
    ref = jdiag.to_dict(jdiag.compute(jg, jvg, jcfg, _from_numpy(d)))
    out = obs_diag.to_dict(obs_diag.compute(
        geom, vg, cfg, convert.state_from_numpy(d, device="cpu")))
    assert set(out) == set(ref)
    for k, v in ref.items():
        if k in ("nonfinite", "bad_field", "bad_cell", "bad_field_name"):
            assert out[k] == v, (k, out[k], v)
        elif math.isfinite(v):
            assert abs(out[k] - v) <= 1e-10 * max(abs(v), 1e-30), (k, out[k], v)
        else:
            assert not math.isfinite(out[k]), (k, out[k])
    assert out["nonfinite"] == (poison is not None)
    assert out["bad_field_name"] == poison


def test_obs_smoke_cli_on_cpu(tmp_path):
    """`python -m repro_torch.obs_smoke --device cpu` exits 0 and writes a
    JSONL that JAX's schema accepts, with a profiler trace when asked."""
    run = tmp_path / "run"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs_smoke", "--device", "cpu",
         "--run-dir", str(run), "--trace"],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT),
        env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert "OK" in res.stdout
    n_ok, errors = jschema.validate_file(str(run / "metrics.jsonl"))
    assert errors == [] and n_ok > 3
    assert obs_smoke.check_jsonl(str(run / "metrics.jsonl"), 3) == []
    assert (run / trace.TRACE_FILE).is_file()


def test_obs_smoke_halts_on_a_violation(tmp_path, monkeypatch):
    """A monitor violation exits 2 and still flushes a valid JSONL."""
    real = obs_diag.MonitorPolicy.__init__

    def tight(self, **kw):
        real(self, **{**kw, "cfl_max": 1e-9})
    monkeypatch.setattr(obs_diag.MonitorPolicy, "__init__", tight)
    rc = obs_smoke.main(["--device", "cpu", "--steps", "1",
                         "--run-dir", str(tmp_path)])
    assert rc == 2
    n_ok, errors = schema.validate_file(str(tmp_path / "metrics.jsonl"))
    assert errors == [] and n_ok >= 2
    assert metrics.default().sink is None
