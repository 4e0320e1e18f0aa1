"""Fault-tolerant simulation campaign launcher (and chaos-test harness).

Runs the standing-wave ocean case through ``SimulationRunner``:
``step_with_diagnostics`` steps, a halt-mode ``MonitorPolicy``, periodic
verified checkpoints, and the graceful-degradation dt ladder.  With
``--fault`` specs (``kind@site[:k=v,...]``, see ``runtime/chaos.py``) the
same campaign runs under a seeded ``FaultPlan``:

  PYTHONPATH=src python -m repro_torch.launch.sim_campaign --steps 12 \
      --ckpt-every 3 --fault poison_nan@sim.state:step=7,field=T \
      [--device cuda|cpu]

It runs on the card unless ``--device cpu`` is given.  ``build_case``
here is the single source of the tiny campaign case used by
``repro_torch.chaos_smoke`` and the port's chaos tests.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from .. import tree as T
from ..core import dg2d, geometry, mesh2d, stepper
from ..core.extrusion import VGrid
from ..kernels.dispatch import default_device
from ..runtime import chaos
from ..runtime.fault_tolerance import (LadderConfig, RunnerConfig,
                                       SimulationRunner)


@dataclasses.dataclass(frozen=True)
class Case:
    geom: geometry.Geom2D
    vg: VGrid
    cfg: stepper.OceanConfig
    state: stepper.OceanState


def build_case(nx: int = 6, ny: int = 5, lx: float = 2000.0,
               ly: float = 1500.0, depth: float = 20.0, nl: int = 4,
               dt: float = 5.0, m_2d: int = 6, amp: float = 0.05,
               dtype=torch.float64, seed: int = 3, device=None,
               backend: str = "auto") -> Case:
    """Tiny standing-wave case (the obs-smoke configuration) on ``device``
    (the card unless another device is asked for)."""
    device = default_device(device)
    m = mesh2d.rect_mesh(nx, ny, lx, ly, jitter=0.2, seed=seed)
    geom = geometry.geom2d_from_mesh(m, dtype=dtype, device=device)
    cfg = stepper.OceanConfig(dt=dt, nl=nl, m_2d=m_2d, backend=backend)
    vg = VGrid(b=torch.full((3, m.nt), depth, dtype=dtype, device=device),
               nl=nl)
    st = stepper.init_state(geom, vg, dtype=dtype)
    eta = (amp * torch.cos(math.pi * geom.node_x / lx)).to(dtype)
    st = dataclasses.replace(st, ext=dg2d.State2D(eta, st.ext.qx, st.ext.qy))
    return Case(geom=geom, vg=vg, cfg=cfg, state=st)


def _to(tree, device):
    return T.map_leaves(
        lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, tree)


def make_step_factory(case: Case) -> Callable:
    """step_factory for SimulationRunner: cfg -> ``state -> (state,
    Diagnostics)`` (a dt-ladder rung is a new cfg).  The step runs on the
    device of the state it is given: a state that a recovery restored onto
    another device steps there, with the case's geometry copied there
    once."""
    from ..obs import diagnostics as obs_diag
    on: Dict[torch.device, tuple] = {case.geom.area.device: (case.geom,
                                                             case.vg)}

    def factory(cfg: stepper.OceanConfig):
        def step_fn(s):
            dev = s.ux.device
            if dev not in on:
                on[dev] = (_to(case.geom, dev), _to(case.vg, dev))
            geom, vg = on[dev]
            return obs_diag.step_with_diagnostics(geom, vg, cfg, s)
        return step_fn
    return factory


def default_policy(cfl_max: float = 1.0):
    from ..obs import diagnostics as obs_diag
    return obs_diag.MonitorPolicy(cfl_max=cfl_max, on_violation="halt")


def run_campaign(case: Case, n_steps: int, runner_cfg: RunnerConfig,
                 ladder: Optional[LadderConfig] = None,
                 policy=None, plan: Optional[chaos.FaultPlan] = None,
                 resume: bool = True):
    """One campaign leg; returns (final_state, runner).  A preempted leg
    returns early with a blocking checkpoint on disk: rerun with
    ``resume=True`` to finish (what the scheduler does after SIGTERM)."""
    runner = SimulationRunner(make_step_factory(case), case.cfg, runner_cfg,
                              policy=policy, ladder=ladder)
    ctx = chaos.active(plan) if plan is not None else _null_ctx()
    with ctx:
        out = runner.run(case.state, n_steps, resume=resume)
    return out, runner


class _null_ctx:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--nx", type=int, default=6)
    ap.add_argument("--ny", type=int, default=5)
    ap.add_argument("--nl", type=int, default=4)
    ap.add_argument("--dt", type=float, default=5.0)
    ap.add_argument("--ckpt", default="checkpoints/sim")
    ap.add_argument("--ckpt-every", type=int, default=3)
    ap.add_argument("--max-retries", type=int, default=3)
    ap.add_argument("--cfl-max", type=float, default=1.0)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--fault", action="append", default=[],
                    help="chaos spec kind@site[:k=v,...] (repeatable)")
    ap.add_argument("--seed", type=int, default=0, help="FaultPlan seed")
    ap.add_argument("--metrics", default=None,
                    help="JSONL metrics sink path")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    from ..obs import metrics as obs_metrics
    device = default_device(args.device)
    if args.metrics:
        obs_metrics.configure(args.metrics)

    case = build_case(nx=args.nx, ny=args.ny, nl=args.nl, dt=args.dt,
                      device=device)
    runner_cfg = RunnerConfig(checkpoint_dir=args.ckpt,
                              checkpoint_every=args.ckpt_every,
                              max_retries=args.max_retries,
                              backoff_base_s=0.01)
    plan = (chaos.plan_from_specs(args.fault, seed=args.seed)
            if args.fault else None)
    st, runner = run_campaign(case, args.steps, runner_cfg,
                              policy=default_policy(args.cfl_max),
                              plan=plan, resume=not args.no_resume)
    print(f"steps={runner.stats['steps']} retries={runner.stats['retries']} "
          f"cold_restores={runner.stats['cold_restores']} "
          f"ladder={runner.stats['ladder_transitions']} "
          f"preempted={runner.stats['preempted']} "
          f"t={float(st.time):.1f}s device={device}")
    if plan is not None:
        for rec in plan.log:
            print(f"chaos fired: {rec}")
    if args.metrics:
        obs_metrics.default().flush(step=args.steps)
        obs_metrics.default().close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
