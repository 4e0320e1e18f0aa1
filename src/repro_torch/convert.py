"""Carry geometry, vertical grid, model state and forcing across frameworks
as plain dicts of numpy arrays, keyed by the field names of the JAX
package's dataclasses (`Geom2D`, `VGrid`, `OceanState` with its nested
`ext`, `Forcing3D` with its nested `forcing2d`).

    geom = geom_from_numpy({f: np.asarray(getattr(jgeom, f)) for f in ...})
    st = state_from_numpy(d, device="cpu")
    d = state_to_numpy(st)
    forcing = forcing_from_numpy({"tau_x": ..., "forcing2d": {...}})

and an LM's parameter tree (`models.model.Model.init`'s, JAX's
`Model.init`'s) as the nested dict of numpy arrays that
`jax.tree_util.tree_map(np.asarray, params)` gives:

    params = lm_params_from_numpy(tree, device="cpu")
    tree = lm_params_to_numpy(params)

and AdamW's state (JAX's `optim.adamw.AdamWState` with numpy leaves, or
anything with fields m, v and step) as the port's `AdamWState`, whose
leaves a checkpoint names as JAX's (``.m/blocks/...``, ``.step``):

    opt = adamw_state_from_numpy(jax.tree_util.tree_map(np.asarray, jopt))
    m, v, step = adamw_state_to_numpy(opt)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.dg2d import Forcing2D, State2D
from .core.extrusion import VGrid
from .core.geometry import Geom2D
from .core.stepper import Forcing3D, OceanState
from . import tree as _tree
from .kernels.dispatch import default_device
from .optim.adamw import AdamWState

_INDEX_FIELDS = ("ext_tri", "ext_na", "ext_nb")


def _tensor(x, device, dtype=None) -> torch.Tensor:
    # a writable copy: arrays exported by other frameworks may be read-only
    return torch.as_tensor(np.array(x, order="C"), device=device, dtype=dtype)


def geom_from_numpy(d: dict, device=None) -> Geom2D:
    """Geom2D from a dict of its fields, each keeping its numpy dtype
    except the index fields, which become int64."""
    device = default_device(device)
    kw = {}
    for f in dataclasses.fields(Geom2D):
        kind = torch.int64 if f.name in _INDEX_FIELDS else None
        kw[f.name] = _tensor(d[f.name], device, kind)
    return Geom2D(**kw)


def vgrid_from_numpy(d: dict, device=None) -> VGrid:
    return VGrid(b=_tensor(d["b"], default_device(device)), nl=int(d["nl"]))


def state_from_numpy(d: dict, device=None) -> OceanState:
    """OceanState from a dict of its fields, with ``d["ext"]`` a dict of
    the State2D fields (eta, qx, qy)."""
    device = default_device(device)
    t = lambda x: _tensor(x, device)
    ext = State2D(**{k: t(d["ext"][k]) for k in ("eta", "qx", "qy")})
    kw = {f.name: t(d[f.name]) for f in dataclasses.fields(OceanState)
          if f.name != "ext"}
    return OceanState(ext=ext, **kw)


def state_to_numpy(st: OceanState) -> dict:
    n = lambda x: x.detach().cpu().numpy()
    d = {f.name: n(getattr(st, f.name)) for f in dataclasses.fields(OceanState)
         if f.name != "ext"}
    d["ext"] = {k: n(getattr(st.ext, k)) for k in ("eta", "qx", "qy")}
    return d


def forcing_from_numpy(d: dict, device=None) -> Forcing3D:
    """Forcing3D from a dict of its fields, with ``d["forcing2d"]`` a dict
    of the Forcing2D fields; a field that is missing or None stays None
    (its term is off)."""
    device = default_device(device)

    def fields(cls, src):
        return {f.name: None if src.get(f.name) is None
                else _tensor(src[f.name], device)
                for f in dataclasses.fields(cls) if f.name != "forcing2d"}
    return Forcing3D(forcing2d=Forcing2D(**fields(Forcing2D,
                                                  d.get("forcing2d") or {})),
                     **fields(Forcing3D, d))


def _bfloat16_leaf(x: np.ndarray) -> torch.Tensor:
    """A numpy bfloat16 array (ml_dtypes', which JAX exports) by its bits."""
    return torch.from_numpy(np.array(x, order="C").view(np.int16)).view(
        torch.bfloat16)


def lm_params_from_numpy(tree: dict, device=None, dtype=None) -> dict:
    """The port's parameter tree from JAX's, leaf for leaf: the same nested
    dict keys (paths spelled as `tree.key_name` spells them, e.g.
    ``blocks/sub0/attn/wq``), shapes and dtypes, bfloat16 included.
    ``dtype`` casts every floating leaf to it (None: each leaf keeps its
    own)."""
    device = default_device(device)

    def leaf(x):
        x = np.asarray(x)
        t = (_bfloat16_leaf(x).to(device) if x.dtype.name == "bfloat16"
             else _tensor(x, device))
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t
    return _tree.map_leaves(leaf, tree)


def lm_params_to_numpy(params: dict) -> dict:
    """JAX's nested dict of numpy arrays from the port's parameter tree;
    bfloat16 leaves become float32 (exact), as numpy has no bfloat16."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return _tree.map_leaves(leaf, params)


def adamw_state_from_numpy(opt, device=None) -> AdamWState:
    """The port's AdamW state from JAX's (fields m, v, step; numpy leaves):
    the moments leaf for leaf (float32), step an int32 scalar."""
    device = default_device(device)
    return AdamWState(m=lm_params_from_numpy(opt.m, device),
                      v=lm_params_from_numpy(opt.v, device),
                      step=torch.as_tensor(np.array(opt.step, np.int32),
                                           device=device))


def adamw_state_to_numpy(opt: AdamWState) -> AdamWState:
    """The AdamW state with numpy leaves, fields in JAX's order (m, v, step):
    `repro.optim.adamw.AdamWState(*adamw_state_to_numpy(opt))` is JAX's."""
    return AdamWState(m=lm_params_to_numpy(opt.m), v=lm_params_to_numpy(opt.v),
                      step=opt.step.detach().cpu().numpy())
