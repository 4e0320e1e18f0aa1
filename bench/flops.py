"""Count the operations of one step of the plain reference, the work the
step has to do whatever implements it: one operation a pointwise element
(and a reduced element), 2 m n k a matrix product, and (2/3) n^3 + 2 n^2 k
an LU solve of n unknowns with k right-hand sides.  Views, copies, gathers
and concatenations count nothing.

Every operator of the step but a few on scalars (the time) works on whole
(..., nt) tensors, so the count is a nt + c, a and c set by the depth and
the sub-steps: it is counted on two small meshes and taken to the cell's.

    python3 -m bench.flops --workload <cell>

prints the cell's count (``flops_per_step``, ``per_triangle`` a and
``constant`` c, for `cells/<workload>.json`).
"""
from __future__ import annotations

import argparse
import json
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import inputs, sides, spec

aten = torch.ops.aten
_MATMUL = {aten.mm.default, aten.bmm.default}
_REDUCE = {aten.sum.dim_IntList, aten.sum.default, aten.mean.dim,
           aten.cumsum.default}


class FlopCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.flops += self.count(func, args, out)
        return out

    @staticmethod
    def count(func, args, out) -> int:
        if func in _MATMUL:
            a, b = args
            return 2 * math.prod(a.shape[:-1]) * a.shape[-1] * b.shape[-1]
        if func is aten._linalg_solve_ex.default:
            a, b = args[0], args[1]
            n = a.shape[-1]
            k = b.shape[-1] if b.dim() == a.dim() else 1
            return math.prod(a.shape[:-2]) * ((2 * n ** 3) // 3 + 2 * n * n * k)
        if func in _REDUCE:
            return args[0].numel()
        if torch.Tag.pointwise in func.tags:
            return out.numel() if isinstance(out, torch.Tensor) else 0
        return 0


def count_step(workload: str, nx: int, seed: int = 0) -> tuple:
    """(flops of one reference step at nx x nx/2 cells, that mesh's nt)."""
    wl = spec.workload(workload)
    case = dict(spec.config(wl["config"]))
    mesh = dict(case["mesh"])
    scale = nx / mesh["nx"]
    mesh.update(nx=nx, ny=nx // 2, lx=mesh["lx"] * scale,
                ly=mesh["ly"] * scale)
    case["mesh"] = mesh
    traffic = spec.traffic(wl["traffic"])
    dev = torch.device("cpu")
    inp = inputs.make_inputs(case, traffic, seed, dev)
    ref = sides.build(sides.reference_modules(), inp,
                      getattr(torch, case["dtype"]), dev)
    st = ref.advance(ref.state)
    with FlopCounter() as fc:
        ref.advance(st)
    return fc.flops, inp.mesh.nt


SIZES = (12, 24)      # the two small meshes counted, nx x nx/2 cells


def fit(workload: str) -> dict:
    """The count a nt + c of the workload's step at the cell's nt."""
    (f1, n1), (f2, n2) = (count_step(workload, nx) for nx in SIZES)
    a = (f2 - f1) // (n2 - n1)
    c = f1 - a * n1
    if f2 != a * n2 + c:
        raise ValueError(f"the count is not a nt + c: {f1} at {n1}, "
                         f"{f2} at {n2}")
    m = spec.config(spec.workload(workload)["config"])["mesh"]
    nt = 2 * m["nx"] * m["ny"]
    return {"flops_per_step": a * nt + c, "per_triangle": a, "constant": c}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    args = ap.parse_args(argv)
    print(json.dumps(fit(args.workload)))


if __name__ == "__main__":
    main()
