"""Multi-rank dry run of the ocean cells (the JAX package's
`launch/dryrun.py`, its `--ocean` path).

For each cell and production mesh, rank 0's step is traced on a fake group
of the mesh's size (`launch/ocean_dryrun.py: trace_ocean`) and the record
is written as JSON with the JAX package's keys (`memory`, `cost_analysis`,
`hlo`, `roofline`), so `roofline/rederive.py` reads either framework's.
The roofline is taken on the H100 model at the cell's dtype (float32).
Where JAX records `compile_s` and `parse_s`, the port records `trace_s`
(the warm-up and the counted step) and `build_s` (the rank's partition and
geometry), beside `machine`, `dtype`, `device` and, traced on the card,
the card's name and power limit.

The LM cells (`lower_cell`, `--arch`, `--shape`, `--no-zero1`) are not
ported yet (ROADMAP.md, section A1): without ``--ocean`` this exits with
status 2.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --ocean [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --ocean \\
      --ocean-config benchmark,benchmark-ca2,gbr --mesh both --out build/dryrun
"""
from __future__ import annotations

import argparse
import json
import os
import traceback
from typing import Dict, Iterable, Optional

from ..roofline import analysis
from .mesh import MeshSpec, production_spec

DEFAULT_OUT = "build/dryrun"
MACHINE = analysis.H100_SXM


def analyze(traced, aux: dict, spec: MeshSpec, verbose: bool = True) -> dict:
    """The record of a traced rank step (`ocean_dryrun.StepTrace`), with
    its roofline on the H100 model at the traced dtype."""
    stats = traced.stats
    roof = analysis.roofline_from_stats(
        stats, spec.size, aux.get("model_flops", 0.0), machine=MACHINE,
        dtype=traced.dtype, cost_analysis_flops=stats.flops)
    rec = dict(
        aux,
        mesh_shape=list(spec.sizes),
        chips=spec.size,
        trace_s=round(traced.trace_s, 2),
        machine=MACHINE.name,
        dtype=traced.dtype,
        device=traced.device,
        partition=traced.partition,
        n_ops=traced.n_ops,
        kernels=traced.kernels,
        memory=traced.memory,
        # no compiler's cost analysis: the trace's own counts
        cost_analysis=dict(flops=stats.flops, bytes_accessed=stats.bytes),
        hlo=dict(flops=stats.flops, bytes=stats.bytes,
                 coll_bytes=stats.coll_bytes,
                 n_collectives=stats.n_collectives,
                 coll_by_kind=stats.coll_by_kind,
                 bytes_by_source=stats.bytes_by_source),
        roofline=roof.to_dict(),
    )
    if traced.card is not None:
        rec["card"] = traced.card
    if traced.step_ms is not None:
        rec["step_ms"] = traced.step_ms
    if verbose:
        print(summary(rec), flush=True)
    return rec


def summary(rec: dict) -> str:
    """The one-line summary of a record (JAX's, with the trace's time)."""
    r = rec["roofline"]
    return (f"  mem/dev={rec['memory']['peak_per_device'] / 2**30:.2f}GiB "
            f"compute={r['compute_s'] * 1e3:.2f}ms "
            f"mem={r['memory_s'] * 1e3:.2f}ms "
            f"coll={r['collective_s'] * 1e3:.2f}ms dom={r['dominant']} "
            f"useful={r['useful_ratio']:.2f} "
            f"roofline_frac={r['roofline_fraction']:.3f} "
            f"[trace {rec['trace_s']}s on {rec['device']}]")


def run_ocean_cells(specs: Dict[str, MeshSpec], out_dir: str,
                    configs: Iterable[str] = ("benchmark",), device=None):
    """Trace each cell on each mesh and write `<out>/<mesh>/ocean-<cell>.json`,
    skipping a record that is there already; returns the failures."""
    from . import ocean_dryrun
    os.makedirs(out_dir, exist_ok=True)
    failures = []
    for mesh_name, spec in specs.items():
        for cname in configs:
            tag = f"{mesh_name}/ocean-{cname}"
            out_path = os.path.join(out_dir, mesh_name, f"ocean-{cname}.json")
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            if os.path.exists(out_path):
                print(f"[skip] {tag} (cached)", flush=True)
                continue
            print(f"[cell] {tag}", flush=True)
            try:
                rec = ocean_dryrun.trace_ocean(cname, spec, device=device,
                                               verbose=True)
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=1)
            except Exception as e:    # a cell's failure is reported, the sweep goes on
                traceback.print_exc()
                failures.append((tag, repr(e)))
    return failures


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--ocean", action="store_true")
    ap.add_argument("--ocean-config", default="benchmark")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    if not args.ocean:
        print("dryrun: the LM cells are not ported yet (ROADMAP.md, section "
              "A1); run the ocean cells with --ocean")
        raise SystemExit(2)
    specs = {}
    if args.mesh in ("single", "both"):
        specs["single_pod"] = production_spec(multi_pod=False)
    if args.mesh in ("multi", "both"):
        specs["multi_pod"] = production_spec(multi_pod=True)
    fails = run_ocean_cells(specs, args.out,
                            configs=args.ocean_config.split(","),
                            device=args.device)
    if fails:
        print("FAILURES:")
        for tag, err in fails:
            print(" ", tag, err)
        raise SystemExit(1)
    print("dry-run complete: all cells traced.")


if __name__ == "__main__":
    main()
