"""Multi-rank dry run (the JAX package's `launch/dryrun.py`): every LM cell
(architecture x applicable shape x production mesh) and the ocean cells.

For each cell and mesh, rank 0's step is traced on a fake group of the
mesh's size (`launch/lm_dryrun.py: trace_cell`, the counterpart of JAX's
`lower_cell` + `compile_and_analyze`; `launch/ocean_dryrun.py:
trace_ocean` with ``--ocean``) and the record is written as JSON with the
JAX package's keys (`memory`, `cost_analysis`, `hlo`, `roofline`), so
`roofline/rederive.py` reads either framework's.  The roofline is taken on
the H100 model at the cell's dtype (bfloat16 for the LM cells, float32 for
the ocean's).  Where JAX records `compile_s` and `parse_s`, the port
records `trace_s` (the warm-up and the counted step; the ocean cells also
`build_s`, the rank's partition and geometry), beside `machine`, `dtype`,
`device`, `n_ops`, `kernels` and, traced on the card, the card's name and
power limit.  A record that is there already is skipped (delete it to
trace the cell again); a cell that fails is reported and the sweep goes on.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch all] \
      [--shape all] [--mesh both] [--no-zero1] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --ocean [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --ocean \
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
# the table's short names of the kernels and of JAX's collective kinds
KERNEL_IDS = {"flash_attention": "K9", "wkv6": "K8"}
COLL_IDS = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS",
            "all-to-all": "A2A", "collective-permute": "CP"}
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
        n_ops=traced.n_ops,
        kernels=traced.kernels,
        memory=traced.memory,
        # no compiler's cost analysis: the trace's own counts
        cost_analysis=dict(flops=stats.flops, bytes_accessed=stats.bytes),
        hlo=dict(flops=stats.flops, bytes=stats.bytes,
                 coll_bytes=stats.coll_bytes,
                 n_collectives=stats.n_collectives,
                 coll_by_kind=stats.coll_by_kind,
                 bytes_by_source=stats.bytes_by_source, **traced.hlo_extra),
        roofline=roof.to_dict(),
    )
    if traced.partition is not None:
        rec["partition"] = traced.partition
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


def _run_cells(cells, out_dir: str, trace):
    """Trace each (mesh name, record name, tag, args) of ``cells`` with
    ``trace(*args)`` into `<out>/<mesh>/<record name>.json`, skipping a
    record that is there already; returns the failures, (tag, error)."""
    failures = []
    for mesh_name, rec_name, tag, args in cells:
        out_path = os.path.join(out_dir, mesh_name, f"{rec_name}.json")
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        if os.path.exists(out_path):
            print(f"[skip] {tag} (cached)", flush=True)
            continue
        print(f"[cell] {tag}", flush=True)
        try:
            rec = trace(*args)
            with open(out_path, "w") as f:
                json.dump(rec, f, indent=1)
        except Exception as e:    # a cell's failure is reported, the sweep goes on
            traceback.print_exc()
            failures.append((tag, repr(e)))
    return failures


def run_lm_cells(arch_names: Iterable[str], shape_names, specs: Dict[str, MeshSpec],
                 out_dir: str, zero1: bool = True, device=None):
    """Trace every applicable shape of each architecture (``shape_names``
    "all" or a list) on each mesh: `<out>/<mesh>/<arch>__<shape>.json`."""
    from ..configs import applicable_shapes, get_arch
    from . import lm_dryrun
    cells = []
    for mesh_name, spec in specs.items():
        for an in arch_names:
            try:
                shapes = applicable_shapes(get_arch(an))
            except KeyError:        # traced all the same, to be reported
                shapes = ["all"] if shape_names == "all" else shape_names
            for sn in shapes:
                if shape_names == "all" or sn in shape_names:
                    cells.append((mesh_name, f"{an}__{sn}",
                                  f"{mesh_name}/{an}_{sn}",
                                  (an, sn, spec, device, zero1, True)))
    return _run_cells(cells, out_dir, lm_dryrun.trace_cell)


def run_ocean_cells(specs: Dict[str, MeshSpec], out_dir: str,
                    configs: Iterable[str] = ("benchmark",), device=None):
    """Trace each cell on each mesh: `<out>/<mesh>/ocean-<cell>.json`."""
    from . import ocean_dryrun

    def trace(cname, spec):
        return ocean_dryrun.trace_ocean(cname, spec, device=device,
                                        verbose=True)
    cells = [(mesh_name, f"ocean-{cname}", f"{mesh_name}/ocean-{cname}",
              (cname, spec))
             for mesh_name, spec in specs.items() for cname in configs]
    return _run_cells(cells, out_dir, trace)


def table(out_dir: str, meshes=("single_pod", "multi_pod")) -> str:
    """The LM records under ``out_dir`` as a markdown table, a row a cell
    (architecture x shape), each field "<single_pod> / <multi_pod>": peak
    a rank, bytes (and the largest sources), flops, collective bytes by
    kind and their count, the roofline's terms, its dominant term and
    useful ratio, and each kernel's calls at their local shapes."""
    from ..configs import ALL_ARCHS, applicable_shapes
    g = lambda v, k=1e9: f"{v / k:.4g}"

    def fields(rec):
        h, r = rec["hlo"], rec["roofline"]
        top = sorted(h["bytes_by_source"].items(), key=lambda kv: -kv[1])[:2]
        kern = ", ".join(
            f"{KERNEL_IDS[n]} {k['calls']} x "
            + "|".join(dict.fromkeys("(" + ",".join(map(str, c["shapes"][0]))
                                     + ")" for c in k["shapes"]))
            for n, k in rec["kernels"].items()) or "-"
        return [g(rec["memory"]["peak_per_device"], 2 ** 30), g(h["bytes"]),
                ", ".join(f"{t} {g(v)}" for t, v in top), g(h["flops"], 1e12),
                ", ".join(f"{COLL_IDS[t]} {g(v)}"
                          for t, v in h["coll_by_kind"].items()) or "0",
                str(h["n_collectives"]),
                "/".join(f"{r[k] * 1e3:.4g}" for k in
                         ("compute_s", "memory_s", "collective_s")),
                r["dominant"], f"{r['useful_ratio']:.3g}", kern]
    head = ["cell", "peak GiB", "hlo.bytes GB", "largest sources GB",
            "hlo.flops TFLOP", "coll GB by kind", "n_coll",
            "compute/memory/collective ms", "dominant", "useful",
            "K9 / K8 calls x local (BH,T,d)"]
    lines = ["| " + " | ".join(head) + " |", "|" + "---|" * len(head)]
    for an in sorted(ALL_ARCHS):
        for sn in applicable_shapes(ALL_ARCHS[an]):
            per = []
            for m in meshes:
                path = os.path.join(out_dir, m, f"{an}__{sn}.json")
                if os.path.exists(path):
                    with open(path) as f:
                        per.append(fields(json.load(f)))
                else:
                    per.append(["no record"] * (len(head) - 1))
            lines.append(f"| {an} {sn} | " + " | ".join(
                " / ".join(dict.fromkeys(col)) for col in zip(*per)) + " |")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> None:
    from ..configs import ALL_ARCHS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--ocean", action="store_true")
    ap.add_argument("--ocean-config", default="benchmark")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    ap.add_argument("--table", action="store_true",
                    help="print the LM records under --out as a table")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return
    specs = {}
    if args.mesh in ("single", "both"):
        specs["single_pod"] = production_spec(multi_pod=False)
    if args.mesh in ("multi", "both"):
        specs["multi_pod"] = production_spec(multi_pod=True)
    if args.ocean:
        fails = run_ocean_cells(specs, args.out,
                                configs=args.ocean_config.split(","),
                                device=args.device)
    else:
        archs = (sorted(ALL_ARCHS) if args.arch == "all"
                 else args.arch.split(","))
        shapes = "all" if args.shape == "all" else args.shape.split(",")
        fails = run_lm_cells(archs, shapes, specs, args.out,
                             zero1=not args.no_zero1, device=args.device)
    if fails:
        print("FAILURES:")
        for tag, err in fails:
            print(" ", tag, err)
        raise SystemExit(1)
    print("dry-run complete: all cells traced.")


if __name__ == "__main__":
    main()
