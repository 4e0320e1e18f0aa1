"""Deterministic fault injection (chaos harness) for simulation campaigns.

Week-long coastal campaigns on many cards see *something always failing*.
This module makes every failure class the runtime claims to survive
reproducible on a laptop: a seeded ``FaultPlan`` fires faults at named
*sites* placed in the production code, so a recovery path is a test, not a
hope.  Sites, kinds, the plan's draws and its log are the JAX package's:
the same plan poisons the same element of the same field in both, and the
two logs compare equal.

Sites (each a ``chaos.site(...)`` marker; a no-op unless a plan is active):

  ``sim.state``                value hook on the state entering a step:
                               NaN/Inf poisoning of a chosen field at a
                               chosen step (found downstream by the
                               ``obs.diagnostics`` non-finite localiser)
  ``runner.step``              event hook at the top of the runner loop:
                               simulated preemption (SIGTERM to self) and
                               straggler stalls (sleep)
  ``checkpoint.write``         event hook inside the async save worker:
                               raising here simulates a disk/quota failure
                               in the background thread
  ``checkpoint.saved``         event hook after a checkpoint directory has
                               landed: truncate a leaf ``.npy``, delete a
                               leaf, or rewrite the ``latest`` pointer
                               stale/dangling
  ``halo.payload``             value hook on a received halo buffer (the
                               distributed runtime's; ``halo_nan`` fills it
                               with NaN)
  ``runner.restore_shardings`` value hook on the device(s) a recovery
                               restores onto: ``reshard`` swaps them for
                               ``args["device"]``, a restore onto another
                               device

Usage::

    plan = chaos.FaultPlan([chaos.Fault("sim.state", "poison_nan",
                                        step=5, field="T")], seed=0)
    with chaos.active(plan):
        runner.run(state, n_steps=8)
    assert plan.log[0]["kind"] == "poison_nan"

Determinism: a plan is a pure function of (seed, faults); poison positions
come from ``numpy.random.default_rng([seed, step])`` and every firing is
appended to ``plan.log`` and counted in the ``chaos.fired`` metrics counter.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import signal
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import tree as T
from ..obs import metrics as obs_metrics

SITES = ("sim.state", "runner.step", "checkpoint.write", "checkpoint.saved",
         "halo.payload", "runner.restore_shardings")

KINDS = ("poison_nan", "poison_inf",          # sim.state
         "preempt", "stall",                  # runner.step
         "io_error",                          # checkpoint.write
         "truncate", "drop_leaf",             # checkpoint.saved
         "stale_latest", "dangling_latest",   # checkpoint.saved
         "halo_nan",                          # halo.payload
         "reshard")                           # runner.restore_shardings


@dataclasses.dataclass
class Fault:
    """One injectable failure: fire ``kind`` at ``site`` when the step
    matches, at most ``count`` times (count<=0: unlimited)."""
    site: str
    kind: str
    step: Optional[int] = None     # fire when ctx step == this (None: always)
    field: Optional[str] = None    # leaf-name selector (poison / drop_leaf /
                                   # truncate); None: seeded random leaf
    count: int = 1
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    fired: int = 0                 # mutable firing counter

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown chaos site {self.site!r}; "
                             f"sites: {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"kinds: {KINDS}")


def _leaf_segments(path) -> List[str]:
    """Identifier segments of a key path ('.ext.eta' -> ['ext', 'eta'])."""
    return re.findall(r"[A-Za-z0-9_]+", T.keystr(path))


class FaultPlan:
    """A seeded, ordered set of faults plus the log of what actually fired."""

    def __init__(self, faults, seed: int = 0):
        self.faults = list(faults)
        self.seed = int(seed)
        self.log: List[dict] = []
        self._lock = threading.Lock()   # sites fire from worker threads too

    # ------------------------------------------------------------------ fire
    def fire(self, site: str, value: Any, step: Optional[int] = None,
             **ctx) -> Any:
        for f in self.faults:
            if f.site != site:
                continue
            if f.step is not None and step != f.step:
                continue
            with self._lock:
                if f.count > 0 and f.fired >= f.count:
                    continue
                f.fired += 1
            value = self._inject(f, value, step, ctx)
        return value

    def _record(self, f: Fault, step, detail: str) -> None:
        with self._lock:
            self.log.append(dict(site=f.site, kind=f.kind, step=step,
                                 detail=detail))
        obs_metrics.default().counter("chaos.fired", site=f.site,
                                      kind=f.kind).inc()

    # -------------------------------------------------------------- injectors
    def _inject(self, f: Fault, value, step, ctx):
        if f.kind in ("poison_nan", "poison_inf"):
            return self._poison(f, value, step)
        if f.kind == "preempt":
            self._record(f, step, "SIGTERM to self")
            os.kill(os.getpid(), signal.SIGTERM)
            return value
        if f.kind == "stall":
            secs = float(f.args.get("seconds", 0.5))
            self._record(f, step, f"stall {secs}s")
            time.sleep(secs)
            return value
        if f.kind == "io_error":
            self._record(f, step, "injected write failure")
            raise OSError("chaos: injected checkpoint write failure")
        if f.kind in ("truncate", "drop_leaf"):
            return self._corrupt_leaf(f, value, step, ctx)
        if f.kind in ("stale_latest", "dangling_latest"):
            return self._corrupt_latest(f, value, step, ctx)
        if f.kind == "halo_nan":
            self._record(f, step, f"halo payload -> NaN "
                                  f"(offset={ctx.get('offset')})")
            return torch.full_like(value, float("nan"))
        if f.kind == "reshard":
            self._record(f, step, "restore shardings swapped")
            return f.args.get("device", value)
        raise AssertionError(f.kind)   # unreachable: validated in Fault

    def _poison(self, f: Fault, tree, step):
        """Set one seeded element of one state leaf to NaN/Inf, in a copy
        of that leaf: the caller's tree stays clean, as the state a
        recovery retries from must."""
        bad = np.nan if f.kind == "poison_nan" else np.inf
        leaves = T.flatten_with_path(tree)
        cands = [i for i, (p, leaf) in enumerate(leaves)
                 if isinstance(leaf, torch.Tensor) and leaf.numel()
                 and leaf.is_floating_point()
                 and (f.field is None or
                      (_leaf_segments(p) and _leaf_segments(p)[-1] == f.field))]
        if not cands:
            raise ValueError(f"chaos poison: no leaf matches "
                             f"field={f.field!r}")
        rng = np.random.default_rng([self.seed, 0 if step is None else step])
        li = cands[int(rng.integers(len(cands)))]
        path, leaf = leaves[li]
        idx = int(rng.integers(leaf.numel()))
        flat = [v for _, v in leaves]
        poisoned = leaf.reshape(-1).clone()
        poisoned[idx] = bad
        flat[li] = poisoned.reshape(leaf.shape)
        self._record(f, step, f"{T.keystr(path)}[{idx}] <- {bad}")
        return T.unflatten(tree, flat)

    def _corrupt_leaf(self, f: Fault, value, step, ctx):
        """Truncate or delete one leaf .npy of the just-written step dir."""
        d = ctx.get("path")
        if not d or not os.path.isdir(d):
            return value
        names = sorted(n for n in os.listdir(d) if n.endswith(".npy"))
        if f.field is not None:
            names = [n for n in names if f.field in n]
        if not names:
            return value
        rng = np.random.default_rng([self.seed, 0 if step is None else step])
        target = os.path.join(d, names[int(rng.integers(len(names)))])
        if f.kind == "drop_leaf":
            os.remove(target)
            self._record(f, step, f"removed {os.path.basename(target)}")
        else:
            size = os.path.getsize(target)
            with open(target, "r+b") as fh:
                fh.truncate(max(size // 2, 1))
            self._record(f, step, f"truncated {os.path.basename(target)} "
                                  f"{size}->{max(size // 2, 1)}B")
        return value

    def _corrupt_latest(self, f: Fault, value, step, ctx):
        root = ctx.get("directory")
        if not root or not os.path.isdir(root):
            return value
        if f.kind == "dangling_latest":
            name = "step_999999999"
        else:   # stale: point at the OLDEST surviving step (or dangle)
            steps = sorted(n for n in os.listdir(root)
                           if n.startswith("step_"))
            name = steps[0] if steps else "step_999999999"
        with open(os.path.join(root, "latest"), "w") as fh:
            fh.write(name)
        self._record(f, step, f"latest -> {name}")
        return value


# ---------------------------------------------------------------------------
# the active plan + the site marker placed in production code
# ---------------------------------------------------------------------------
_active: Optional[FaultPlan] = None


@contextlib.contextmanager
def active(plan: FaultPlan):
    """Arm ``plan`` for the enclosed block (global, so the checkpoint worker
    thread sees it too)."""
    global _active
    prev = _active
    _active = plan
    try:
        yield plan
    finally:
        _active = prev


def site(name: str, value: Any = None, step: Optional[int] = None,
         **ctx) -> Any:
    """Chaos site marker: identity unless a plan is active.

    Value sites return the (possibly corrupted) value; event sites are
    called for their side effects and return ``value`` unchanged."""
    plan = _active
    if plan is None:
        return value
    return plan.fire(name, value, step=step, **ctx)


# ---------------------------------------------------------------------------
# plan parsing (launch CLIs, chaos smoke): "kind@site[:k=v,...]"
# ---------------------------------------------------------------------------
def parse_fault(spec: str) -> Fault:
    """Parse ``kind@site[:key=value,...]``, e.g.
    ``poison_nan@sim.state:step=5,field=T`` or
    ``truncate@checkpoint.saved:step=4``."""
    head, _, tail = spec.partition(":")
    kind, _, site_name = head.partition("@")
    kw: Dict[str, Any] = {}
    args: Dict[str, Any] = {}
    for item in filter(None, tail.split(",")):
        k, _, v = item.partition("=")
        if k in ("step", "count"):
            kw[k] = int(v)
        elif k == "field":
            kw[k] = v
        else:
            args[k] = float(v) if re.fullmatch(r"-?\d+(\.\d+)?", v) else v
    return Fault(site=site_name, kind=kind, args=args, **kw)


def plan_from_specs(specs, seed: int = 0) -> FaultPlan:
    return FaultPlan([parse_fault(s) for s in specs], seed=seed)
