"""The two sides of a run, built from the same `Inputs`: the program
(`repro_torch`'s step, the CUDA kernels on a card) and the plain reference
(`bench/reference`).  Both expose the same modules (`geometry`,
`extrusion`, `dg2d`, `stepper`), so one function builds either, in any
dtype: the control is the reference in the precision below the
configuration's.  `build_rank` builds one rank's side of the program on
a partitioned mesh: `repro_torch.distributed.ocean.DistributedOcean`,
from the same inputs and configuration."""
from __future__ import annotations

import dataclasses
import math
import sys
import types
from pathlib import Path
from typing import Callable

import torch

from .inputs import Inputs
from .spec import ROOT


def port_modules() -> types.SimpleNamespace:
    """`repro_torch`'s core modules, from this checkout's `src/` and from
    nowhere else."""
    src = (ROOT / "src").resolve()
    if not (src / "repro_torch").is_dir():
        raise RuntimeError(f"no repro_torch package under {src}")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch
    found = Path(repro_torch.__file__).resolve().parent.parent
    if found != src:
        raise RuntimeError(f"repro_torch was imported from {found}, "
                           f"not from {src}")
    from repro_torch.core import dg2d, extrusion, geometry, stepper
    return types.SimpleNamespace(dg2d=dg2d, extrusion=extrusion,
                                 geometry=geometry, stepper=stepper)


def rank_modules() -> types.SimpleNamespace:
    """`port_modules` and the port's distributed runtime (`halo`, `ocean`)."""
    mods = port_modules()
    from repro_torch.distributed import halo, ocean
    return types.SimpleNamespace(**vars(mods), halo=halo, ocean=ocean)


def reference_modules() -> types.SimpleNamespace:
    from .reference import dg2d, extrusion, geometry, stepper
    return types.SimpleNamespace(dg2d=dg2d, extrusion=extrusion,
                                 geometry=geometry, stepper=stepper)


@dataclasses.dataclass
class Side:
    """One side's model, built from the inputs: ``advance(state)`` is one
    step with ``forcing_at(state.time)``."""
    geom: object
    vg: object
    cfg: object
    state: object
    forcing_at: Callable
    advance: Callable
    ranks: object = None    # the rank's DistributedOcean (build_rank)


def config(mods: types.SimpleNamespace, inp: Inputs):
    case = inp.case
    return mods.stepper.OceanConfig(
        nl=inp.nl, dt=case["dt"], m_2d=inp.m_2d, eos_kind=case["eos_kind"],
        use_gls=True, coriolis_f=case["coriolis_f"])


def initial_state(mods: types.SimpleNamespace, geom, vg, inp: Inputs,
                  dtype: torch.dtype, ids: torch.Tensor = None):
    """The run's initial state on ``geom``: the inputs' T and eta, fluid at
    rest, uniform S; with ``ids``, at those slots of the whole mesh."""
    case = inp.case
    st = mods.stepper.init_state(geom, vg, T0=case["T0"], S0=case["S0"])
    zero2 = torch.zeros((3, geom.nt), dtype=dtype, device=geom.area.device)
    T, eta = inp.T, inp.eta
    if ids is not None:
        T, eta = T[..., ids], eta[..., ids]
    return dataclasses.replace(
        st, T=T.to(dtype), ext=mods.dg2d.State2D(eta.to(dtype), zero2, zero2))


def build(mods: types.SimpleNamespace, inp: Inputs, dtype: torch.dtype,
          device: torch.device) -> Side:
    geom = mods.geometry.geom2d_from_mesh(inp.mesh, dtype=dtype, device=device)
    z = dict(dtype=dtype, device=device)
    vg = mods.extrusion.VGrid(b=torch.as_tensor(inp.b, **z), nl=inp.nl)
    cfg = config(mods, inp)
    st = initial_state(mods, geom, vg, inp, dtype)
    forcing_at = _forcing(mods, inp, z, geom.nt)

    def advance(s):
        return mods.stepper.step(geom, vg, cfg, s, forcing_at(s.time))
    return Side(geom=geom, vg=vg, cfg=cfg, state=st, forcing_at=forcing_at,
                advance=advance)


def build_rank(mods: types.SimpleNamespace, inp: Inputs, dtype: torch.dtype,
               device: torch.device, rank: int, n_ranks: int) -> Side:
    """Rank ``rank`` of ``n_ranks`` (``mods``: `rank_modules`, after the
    process group is up): `DistributedOcean` on Hilbert stripes at the
    program's default halo depth, with `build`'s configuration; its state
    is the rank's slots of `build`'s initial state, its ``advance`` the
    program's `make_step`."""
    if inp.case.get("forcing") is not None:
        raise ValueError("the port's distributed step takes no field "
                         "forcing: a forced configuration runs on one card")
    cfg = config(mods, inp)
    do = mods.ocean.DistributedOcean(inp.mesh, inp.b, cfg, rank, n_ranks,
                                     mods.halo.Transport(), dtype=dtype,
                                     device=device)
    ids = torch.as_tensor(do.spec.glob_ids[rank], device=inp.T.device)
    st = initial_state(mods, do.geom, do.vg, inp, dtype, ids)
    none = mods.stepper.Forcing3D()
    return Side(geom=do.geom, vg=do.vg, cfg=cfg, state=st,
                forcing_at=lambda t: none, advance=do.make_step(), ranks=do)


def _forcing(mods, inp: Inputs, z: dict, nt: int) -> Callable:
    """forcing_at(time): the configuration's forcing at a time held on the
    device (no host sync), or no forcing."""
    fc = inp.case.get("forcing")
    if fc is None:
        none = mods.stepper.Forcing3D()
        return lambda t: none
    tau_x = torch.full((3, nt), fc["tau"][0], **z)
    tau_y = torch.full((3, nt), fc["tau"][1], **z)
    T_open = torch.full((inp.nl, 6, nt), fc["T_open"], **z)
    S_open = torch.full((inp.nl, 6, nt), fc["S_open"], **z)
    ones = torch.ones((3, nt), **z)

    def forcing_at(t):
        eta_bc = inp.tide_amp * torch.sin(2 * math.pi * t
                                          / fc["tide_period"]) * ones
        return mods.stepper.Forcing3D(
            forcing2d=mods.dg2d.Forcing2D(eta_open=eta_bc),
            tau_x=tau_x, tau_y=tau_y, T_open=T_open, S_open=S_open)
    return forcing_at
