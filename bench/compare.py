"""The comparison that decides `correct`: the program's final state against
the plain reference's, after the same steps from the same inputs.

Each field's number is its widest gap, max |program - reference|, over the
reference field's largest magnitude.  The number has a limit of its own,
kept in the cell's file (`cells/<workload>.json`, ``limits``) with the
readings it was set from; the fields a cell compares are those its limits
name.  A gap that is not finite fails."""
from __future__ import annotations

import math

import torch

FIELDS = ("eta", "ux", "uy", "T", "S", "turb_k", "turb_eps", "nu_t",
          "kappa_t")


def fields(st) -> dict:
    """The compared fields of a state (either side's)."""
    return {"eta": st.ext.eta, "ux": st.ux, "uy": st.uy, "T": st.T,
            "S": st.S, "turb_k": st.turb_k, "turb_eps": st.turb_eps,
            "nu_t": st.nu_t, "kappa_t": st.kappa_t}


def gaps(prog: dict, ref: dict, names=FIELDS) -> dict:
    """name -> max |prog - ref| / max |ref|, in float64."""
    out = {}
    for name in names:
        r = ref[name].to(torch.float64)
        p = prog[name].to(device=r.device, dtype=torch.float64)
        gap = float((p - r).abs().max()) / max(float(r.abs().max()), 1e-300)
        out[name] = gap if math.isfinite(gap) else math.inf
    return out


def judge(gap: dict, limits: dict) -> tuple:
    """(correct, checks): every limited field's gap at or under its limit;
    checks maps each of them to its gap and limit."""
    checks = {name: {"value": gap[name], "limit": limit}
              for name, limit in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
