"""Chaos smoke: a seeded fault matrix on a tiny mesh, asserting recovery.

For each recoverable fault class the same standing-wave campaign runs under
a deterministic ``FaultPlan`` and must (a) complete all steps and (b) end in
a final state that is BITWISE equal (f64) to the fault-free baseline:

  * nan-poison        NaN injected into a state field mid-run; the obs
                      diagnostics localise it, the runner restores the last
                      checkpoint and re-runs
  * corrupt-ckpt      the newest checkpoint is truncated on disk before a
                      NaN failure; restore must fall back to the older
                      intact step
  * preemption        SIGTERM mid-run -> blocking checkpoint + early return;
                      a second leg resumes and finishes
  * save-thread       the async checkpoint worker raises; the error surfaces
                      at the next save and the runner retries synchronously

On the card, the bitwise baseline also needs the step to be deterministic
from run to run; a second fault-free leg checks that first.

Exit codes: 0 ok, 1 failure.

    PYTHONPATH=src python -m repro_torch.chaos_smoke [--steps N]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import torch

from . import tree as T
from .kernels.dispatch import default_device
from .launch import sim_campaign
from .obs import metrics as obs_metrics
from .runtime import chaos
from .runtime.fault_tolerance import RunnerConfig


def _leaf_equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    nan = x.isnan()
    return (x.shape == y.shape and x.dtype == y.dtype
            and x.device == y.device and torch.equal(nan, y.isnan())
            and torch.equal(x[~nan], y[~nan]))


def bitwise_equal(a, b) -> bool:
    """Every leaf of two trees equal (NaN where NaN), with the same shape,
    dtype and device."""
    la, lb = T.leaves(a), T.leaves(b)
    return len(la) == len(lb) and all(_leaf_equal(x, y)
                                      for x, y in zip(la, lb))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    n = args.steps

    device = default_device(args.device)
    case = sim_campaign.build_case(nx=4, ny=3, nl=4, device=device)
    root = tempfile.mkdtemp(prefix="chaos_smoke_")

    def rcfg(name):
        return RunnerConfig(checkpoint_dir=os.path.join(root, name),
                            checkpoint_every=2, max_retries=3,
                            backoff_base_s=0.01, emit_metrics=False)

    def leg(name, plan, resume=False):
        return sim_campaign.run_campaign(
            case, n, rcfg(name), policy=sim_campaign.default_policy(),
            plan=plan, resume=resume)

    failures = []

    def check(name, ok, detail=""):
        status = "ok" if ok else "FAIL"
        print(f"  [{status}] {name}" + (f": {detail}" if detail else ""))
        if not ok:
            failures.append(name)

    try:
        obs_metrics.reset()
        baseline, _ = leg("baseline", plan=None)
        again, _ = leg("baseline2", plan=None)
        print(f"baseline: {n} steps on {device}, t={float(baseline.time):.1f}s")
        check("fault-free legs bitwise", bitwise_equal(again, baseline))

        # --- 1. NaN poisoning -> restore + deterministic re-run -----------
        plan = chaos.FaultPlan([chaos.Fault("sim.state", "poison_nan",
                                            step=n - 1, field="T")],
                               seed=args.seed)
        st, runner = leg("nan", plan)
        check("nan-poison fired", len(plan.log) == 1)
        check("nan-poison recovered", runner.stats["retries"] == 1
              and bitwise_equal(st, baseline),
              f"retries={runner.stats['retries']}")

        # --- 2. corrupt checkpoint -> fallback to older intact step -------
        obs_metrics.reset()
        plan = chaos.FaultPlan(
            [chaos.Fault("checkpoint.saved", "truncate", step=4),
             chaos.Fault("sim.state", "poison_nan", step=n - 1, field="ux")],
            seed=args.seed)
        st, runner = leg("corrupt", plan)
        skipped = obs_metrics.default().snapshot()["counter"].get(
            "checkpoint.corrupt_skipped", 0)
        check("corrupt-ckpt skipped corrupt step", skipped >= 1)
        check("corrupt-ckpt recovered", bitwise_equal(st, baseline),
              f"retries={runner.stats['retries']}")

        # --- 3. preemption -> blocking save, resume leg finishes ----------
        plan = chaos.FaultPlan([chaos.Fault("runner.step", "preempt",
                                            step=n - 2)], seed=args.seed)
        st1, runner1 = leg("preempt", plan)
        check("preemption checkpointed", runner1.stats["preempted"]
              and runner1.ckpt.latest_step() is not None)
        st, runner2 = leg("preempt", plan=None, resume=True)
        check("preemption resumed bitwise", bitwise_equal(st, baseline),
              f"resumed from step {runner1.ckpt.latest_step()}")

        # --- 4. save-thread failure -> surfaced + retried, run completes --
        plan = chaos.FaultPlan([chaos.Fault("checkpoint.write", "io_error",
                                            step=2)], seed=args.seed)
        st, runner = leg("savefail", plan)
        check("save-failure surfaced", runner.stats["ckpt_failures"] >= 1,
              f"ckpt_failures={runner.stats['ckpt_failures']}")
        check("save-failure run completed", bitwise_equal(st, baseline))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    if failures:
        print(f"FAIL chaos smoke: {failures}", file=sys.stderr)
        return 1
    print(f"OK chaos smoke: 4 fault classes recovered, final state bitwise "
          f"== baseline over {n} steps on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
