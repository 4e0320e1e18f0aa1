"""Fault-tolerant runtime: a shared runner core, the training runner, and a
simulation runner with physics-aware recovery.

  * periodic async checkpoints + exact resume (the data iterator's state is
    the step counter, so a restart is bitwise-deterministic),
  * preemption handling: SIGTERM/SIGINT triggers a final blocking checkpoint
    before exit; the previous handlers are restored when ``run`` returns,
  * crash recovery: a failing step (device error, NaN loss/state) restores
    the newest INTACT checkpoint and continues; before the first checkpoint
    exists, recovery re-initialises from the caller's start snapshot (a
    "cold restore") instead of retrying a possibly-inconsistent in-memory
    state; repeated failures back off and eventually re-raise,
  * checkpoint-save failures (which surface from ``Checkpointer.wait`` as
    ``CheckpointError``) are retried once synchronously: a run never
    silently loses its checkpoint cadence,
  * straggler detection: per-step wall-time EMA; steps slower than
    `straggler_factor` x EMA are counted and surfaced through `stats`.

``TrainRunner`` drives ``step_fn(state, batch)`` (loss-shaped).
``SimulationRunner`` drives ``step_fn(state) -> (state, Diagnostics)``
(simulation-shaped) and replaces blind restore-and-retry with a
**graceful-degradation ladder**: a deterministic failure (the CFL blow-up
of an operational shallow-water run) would otherwise restore the same
state, re-run the same step and fail identically until retries run out.
Instead, each consecutive retry climbs a rung (restore, then restore +
halve dt, with ``dt_2d = dt/m_2d`` halving alike, then halve again and
optionally raise the vertical viscosity), and once the CFL diagnostic stays
calm for ``recover_steps`` steps the runner re-widens one rung.  Every
transition is emitted through ``obs.metrics``.

On the card, reading a step's diagnostics (its non-finite flag, the
monitor's bundle, the CFL number) copies a few scalars to the host: one
synchronisation a step, which the runner's step time includes.

Chaos sites (``runtime/chaos.py``): ``runner.step`` (preemption/stall),
``sim.state`` (NaN/Inf poisoning of the state entering a step) and
``runner.restore_shardings`` (the device(s) a recovery restores onto).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ..checkpoint.checkpoint import CheckpointError, Checkpointer
from ..obs import metrics as obs_metrics
from . import chaos


@dataclasses.dataclass
class RunnerConfig:
    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 100
    keep_last: int = 3
    max_retries: int = 3
    straggler_factor: float = 2.0
    nan_is_failure: bool = True
    emit_metrics: bool = True      # stream runner stats to obs.metrics
    backoff_base_s: float = 0.1    # retry backoff: base * 2**retries


@dataclasses.dataclass
class LadderConfig:
    """Graceful-degradation ladder for the simulation runner.

    Rung r runs at ``dt * dt_factor**r`` (and, because ``m_2d`` is kept,
    ``dt_2d`` scales identically) with vertical viscosity raised by
    ``visc_factor**r``.  ``max_rungs=0`` is blind restore-and-retry."""
    dt_factor: float = 0.5
    max_rungs: int = 2
    visc_factor: float = 1.0       # >1: multiply nu_v_bg/kappa_v_bg per rung
    recover_steps: int = 8         # consecutive calm steps before re-widening
    cfl_ok: float = 0.8            # re-widen when projected CFL at the wider
                                   # rung stays below cfl_ok * cfl_limit
    cfl_limit: float = 1.0         # absolute CFL ceiling for the projection


def _diag_nonfinite(diag: Any) -> Optional[str]:
    """Non-finite reason string from a diagnostics entry, or None.

    Accepts the obs.diagnostics.Diagnostics bundle or its to_dict() form;
    anything without a ``nonfinite`` signal is ignored."""
    if diag is None:
        return None
    if isinstance(diag, dict):
        flag, field, cell = (diag.get("nonfinite"),
                             diag.get("bad_field_name", diag.get("bad_field")),
                             diag.get("bad_cell"))
    else:
        flag = getattr(diag, "nonfinite", None)
        field = getattr(diag, "bad_field", None)
        cell = getattr(diag, "bad_cell", None)
        if flag is not None:
            try:
                from ..obs.diagnostics import FIELDS
                fi = int(field)
                field = FIELDS[fi] if 0 <= fi < len(FIELDS) else fi
                cell = int(cell)
            except (TypeError, ValueError):
                pass
    if flag is None or not bool(flag):
        return None
    return f"non-finite state (field={field}, cell={cell})"


def _diag_value(diag: Any, key: str) -> Optional[float]:
    """Float diagnostic by name from a Diagnostics bundle or dict."""
    if diag is None:
        return None
    v = diag.get(key) if isinstance(diag, dict) else getattr(diag, key, None)
    if v is None:
        return None
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


class _RunnerBase:
    """Shared fault-tolerance core: checkpointer, signal handling, recovery,
    straggler accounting, metrics.

    ``state_devices``: where a restore puts the state (one device or a tree
    of devices, `Checkpointer.restore`); None keeps each leaf on its
    template leaf's device."""

    def __init__(self, cfg: RunnerConfig, state_devices: Any = None):
        self.cfg = cfg
        self.ckpt = Checkpointer(cfg.checkpoint_dir, cfg.keep_last)
        self.state_devices = state_devices
        self.stats: Dict[str, Any] = {
            "steps": 0, "retries": 0, "stragglers": 0, "cold_restores": 0,
            "ckpt_failures": 0, "step_time_ema": None, "preempted": False}
        self._preempt = False
        self._prev_handlers: Optional[dict] = None

    # ----------------------------------------------------------- signals
    def _install_signals(self):
        def handler(signum, frame):
            self._preempt = True
        self._prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.getsignal(sig)
                signal.signal(sig, handler)
            except ValueError:
                pass  # not on main thread (tests)

    def _restore_signals(self):
        """Put back whatever handlers were installed before ``run``: the
        runner's handler must not leak into subsequent code or pytest."""
        for sig, prev in (self._prev_handlers or {}).items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._prev_handlers = None

    # ----------------------------------------------------------- metrics
    def _reg(self):
        return obs_metrics.default() if self.cfg.emit_metrics else None

    def _count(self, name: str, **labels):
        reg = self._reg()
        if reg is not None:
            reg.counter(name, **labels).inc()

    def _observe_step_time(self, dt: float):
        ema = self.stats["step_time_ema"]
        if ema is not None and dt > self.cfg.straggler_factor * ema:
            self.stats["stragglers"] += 1
            self._count("runner.stragglers")
        self.stats["step_time_ema"] = dt if ema is None else \
            0.9 * ema + 0.1 * dt
        reg = self._reg()
        if reg is not None:
            reg.histogram("runner.step_time_s").observe(dt)
            reg.gauge("runner.step_time_ema_s").set(
                self.stats["step_time_ema"])

    # -------------------------------------------------------- checkpoints
    def _save(self, step: int, state: Any, blocking: bool = False):
        """Checkpoint with one synchronous retry on failure: an async save
        error (surfaced here from the worker via ``wait``) costs one retry,
        never a silent gap in the checkpoint cadence."""
        try:
            self.ckpt.save(step, state, blocking=blocking)
        except CheckpointError:
            self.stats["ckpt_failures"] += 1
            self._count("runner.ckpt_failures")
            self.ckpt.save(step, state, blocking=True)

    def _drain(self):
        """Final wait; a pending async-save failure is counted, not raised
        over a (possibly) more interesting primary exception."""
        try:
            self.ckpt.wait()
        except CheckpointError:
            self.stats["ckpt_failures"] += 1
            self._count("runner.ckpt_failures")

    def _recover(self, template: Any, start_state: Any,
                 start_step: int) -> Tuple[Any, int]:
        """Newest intact checkpoint, or the caller's start snapshot (cold
        restore) when nothing on disk is restorable yet."""
        devices = chaos.site("runner.restore_shardings", self.state_devices)
        state, step = self.ckpt.restore_latest(template, devices)
        if state is None:
            self.stats["cold_restores"] += 1
            self._count("runner.cold_restores")
            return start_state, start_step
        return state, step

    def _resume(self, state: Any, step: int) -> Tuple[Any, int]:
        latest = self.ckpt.latest_step()
        if latest is not None and latest > step:
            return self.ckpt.restore(state, latest, self.state_devices), latest
        return state, step

    def run(self, state: Any, n_steps: int, start_step: int = 0,
            resume: bool = True) -> Any:
        self._install_signals()
        try:
            return self._run(state, n_steps, start_step, resume)
        finally:
            self._restore_signals()


class TrainRunner(_RunnerBase):
    """Drives step_fn(state, batch) -> (state, metrics) with FT wrapping."""

    def __init__(self, step_fn: Callable, dataset, cfg: RunnerConfig,
                 state_devices: Any = None):
        super().__init__(cfg, state_devices)
        self.step_fn = step_fn
        self.dataset = dataset

    def _run(self, state, n_steps, start_step, resume):
        start_state, start0 = state, start_step   # cold-restore snapshot
        step = start_step
        if resume:
            state, step = self._resume(state, step)
        retries = 0
        while step < n_steps and not self._preempt:
            chaos.site("runner.step", step=step)
            if self._preempt:
                break
            batch = self.dataset.batch_at(step)
            t0 = time.time()
            try:
                new_state, metrics = self.step_fn(state, batch)
                loss = metrics.get("loss") if isinstance(metrics, dict) \
                    else metrics
                if self.cfg.nan_is_failure and loss is not None and \
                        not np.isfinite(float(loss)):
                    raise FloatingPointError(f"non-finite loss at {step}")
                if self.cfg.nan_is_failure and isinstance(metrics, dict):
                    reason = _diag_nonfinite(metrics.get("diagnostics"))
                    if reason is not None:
                        raise FloatingPointError(f"{reason} at {step}")
            except Exception:
                retries += 1
                self.stats["retries"] += 1
                self._count("runner.retries")
                if retries > self.cfg.max_retries:
                    self._drain()
                    raise
                state, step = self._recover(state, start_state, start0)
                time.sleep(self.cfg.backoff_base_s * 2 ** retries)
                continue
            retries = 0
            state = new_state
            self._observe_step_time(time.time() - t0)
            step += 1
            self.stats["steps"] += 1
            if step % self.cfg.checkpoint_every == 0:
                self._save(step, state)
        if self._preempt:
            self.stats["preempted"] = True
            self._save(step, state, blocking=True)
        self._drain()
        return state


class SimulationRunner(_RunnerBase):
    """Drives a simulation step with physics-aware recovery.

    ``step_factory(model_cfg)`` must return a callable
    ``step_fn(state) -> (state, diagnostics)`` (the
    ``obs.diagnostics.step_with_diagnostics`` shape); the runner builds one
    per ladder rung, so a dt change is a new step function, not a new
    runner.  The optional ``MonitorPolicy`` (``on_violation="halt"``) turns
    physics verdicts into step failures; without one, only the non-finite
    flag of the diagnostics is checked.

    Recovery ladder: consecutive retry r restores the newest intact
    checkpoint (or cold-restores from the caller's start snapshot) and runs
    at rung ``min(r-1, max_rungs)``.  Re-widening: while degraded, a step
    whose CFL, projected onto the next-wider rung, stays below
    ``cfl_ok * cfl_limit`` counts as calm; ``recover_steps`` consecutive
    calm steps step the ladder back up one rung."""

    def __init__(self, step_factory: Callable[[Any], Callable],
                 model_cfg: Any, cfg: RunnerConfig,
                 policy: Any = None, ladder: Optional[LadderConfig] = None,
                 state_devices: Any = None):
        super().__init__(cfg, state_devices)
        self.step_factory = step_factory
        self.model_cfg = model_cfg
        self.policy = policy
        self.ladder = ladder or LadderConfig()
        self.rung = 0
        self._step_fns: Dict[int, Callable] = {}
        self.stats.update({"ladder_engagements": 0, "ladder_transitions": 0})

    # ------------------------------------------------------------- ladder
    def _cfg_for_rung(self, rung: int) -> Any:
        if rung == 0:
            return self.model_cfg
        dt_f = self.ladder.dt_factor ** rung
        visc_f = self.ladder.visc_factor ** rung
        if hasattr(self.model_cfg, "with_recovery"):
            return self.model_cfg.with_recovery(dt_factor=dt_f,
                                                visc_factor=visc_f)
        return dataclasses.replace(self.model_cfg,
                                   dt=self.model_cfg.dt * dt_f)

    def _step_fn(self) -> Callable:
        if self.rung not in self._step_fns:
            self._step_fns[self.rung] = self.step_factory(
                self._cfg_for_rung(self.rung))
        return self._step_fns[self.rung]

    def _transition(self, rung: int, step: int, reason: str):
        if rung == self.rung:
            return
        prev, self.rung = self.rung, rung
        self.stats["ladder_transitions"] += 1
        if rung > prev:
            self.stats["ladder_engagements"] += 1
        reg = self._reg()
        if reg is not None:
            reg.counter("sim.ladder.transitions",
                        direction="down" if rung > prev else "up").inc()
            reg.gauge("sim.ladder.rung").set(rung)
            reg.event("sim.ladder.transition",
                      {"from": prev, "to": rung, "reason": reason,
                       "dt": float(getattr(self._cfg_for_rung(rung), "dt",
                                           0.0))}, step=step)

    def _calm(self, diag: Any) -> bool:
        """Would this step's CFL be acceptable one rung wider?"""
        cfl = _diag_value(diag, "cfl_2d")
        if cfl is None or not np.isfinite(cfl):
            return False
        projected = cfl / self.ladder.dt_factor    # dt one rung wider
        return projected < self.ladder.cfl_ok * self.ladder.cfl_limit

    # ---------------------------------------------------------------- run
    def _run(self, state, n_steps, start_step, resume):
        start_state, start0 = state, start_step
        reg = self._reg()
        step = start_step
        if resume:
            state, step = self._resume(state, step)
        retries = 0
        calm = 0
        while step < n_steps and not self._preempt:
            chaos.site("runner.step", step=step)
            if self._preempt:
                break
            t0 = time.time()
            try:
                st_in = chaos.site("sim.state", state, step=step)
                new_state, diag = self._step_fn()(st_in)
                if self.policy is not None:
                    self.policy.check(diag, step=step, registry=reg)
                reason = _diag_nonfinite(diag)
                if self.cfg.nan_is_failure and reason is not None:
                    raise FloatingPointError(f"{reason} at {step}")
            except Exception as e:
                retries += 1
                self.stats["retries"] += 1
                self._count("runner.retries")
                if retries > self.cfg.max_retries:
                    self._drain()
                    raise
                if reg is not None:
                    reg.event("sim.recovery", {"step": step, "retry": retries,
                                               "error": repr(e)}, step=step)
                state, step = self._recover(state, start_state, start0)
                self._transition(min(retries - 1, self.ladder.max_rungs),
                                 step, reason=repr(e))
                calm = 0
                time.sleep(self.cfg.backoff_base_s * 2 ** retries)
                continue
            retries = 0
            state = new_state
            self._observe_step_time(time.time() - t0)
            if self.rung > 0:
                calm = calm + 1 if self._calm(diag) else 0
                if calm >= self.ladder.recover_steps:
                    self._transition(self.rung - 1, step, reason="recovered")
                    calm = 0
            step += 1
            self.stats["steps"] += 1
            if step % self.cfg.checkpoint_every == 0:
                self._save(step, state)
        if self._preempt:
            self.stats["preempted"] = True
            self._save(step, state, blocking=True)
        self._drain()
        return state
