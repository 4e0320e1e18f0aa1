"""Recompute the `roofline` section of stored dry-run records (the JAX
package's `roofline/rederive.py`): no trace is needed, the raw stats are in
the record.

A record of the port names its machine and dtype (`machine`, `dtype`); a
record in the JAX package's format names neither and is re-derived as JAX
does, on TPU v5e at the bf16 peak, so that records of the JAX package's
dry run (which no writer in this package makes) re-derive to JAX's own
figures beside the port's.  ``machine`` overrides the record's.

    PYTHONPATH=src python -m repro_torch.roofline.rederive [ROOT]
"""
from __future__ import annotations

import json
import os
import sys
from typing import Optional

from . import analysis

DEFAULT_ROOT = "build/dryrun"


def rederive(path: str, machine: Optional[analysis.Machine] = None) -> dict:
    """Rewrite the record at ``path`` with its roofline re-derived; returns
    the record."""
    with open(path) as f:
        rec = json.load(f)
    if machine is None:
        machine = analysis.MACHINES[rec.get("machine", "TPU_V5E")]
    st = analysis.HloStats(
        flops=rec["hlo"]["flops"], bytes=rec["hlo"]["bytes"],
        coll_bytes=rec["hlo"]["coll_bytes"],
        coll_by_kind=rec["hlo"].get("coll_by_kind", {}),
        n_collectives=rec["hlo"].get("n_collectives", 0))
    roof = analysis.roofline_from_stats(
        st, rec["chips"], rec.get("model_flops", 0.0), machine=machine,
        dtype=rec.get("dtype", "bf16"),
        cost_analysis_flops=rec.get("cost_analysis", {}).get("flops", 0.0))
    rec["roofline"] = roof.to_dict()
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(root: str = DEFAULT_ROOT) -> int:
    n = 0
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".json"):
                rederive(os.path.join(dirpath, fn))
                n += 1
    print(f"rederived {n} records")
    return n


if __name__ == "__main__":
    main(*sys.argv[1:])
