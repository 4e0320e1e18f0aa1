"""Ocean-model cells of the multi-rank runs (the paper's own workload).

Two configurations, those of the JAX package's `launch/ocean_dryrun.py`:
  * benchmark: the paper's timeline/benchmark mesh class — 210k triangles,
    32 sigma layers (Fig. 2 caption), m=20 external sub-steps;
  * gbr: Great-Barrier-Reef scale — 3.3M triangles (paper §5), 20 layers
    (paper: 10-29 variable; sigma grid uses the mean), reef-belt bathymetry;
and the communication-avoiding variant of the benchmark.

`build_cell` builds one rank's `DistributedOcean` of a cell.
`trace_ocean(cell, spec)` is the port's counterpart of the JAX package's
`lower_ocean`: JAX lowers and compiles the sharded step for the production
mesh and reads its per-device memory, cost and collectives from XLA; the
port has no compiler, so it runs rank 0's step on a fake group of the
mesh's size (`launch/mesh.py: init_fake_group`; the halo shifts move no
data, `distributed/halo.py`) and counts what that rank's program pays:

  * bytes: the operand and result bytes of every aten op that is not a
    view (nor an allocation or a reshape of metadata), read by a
    `TorchDispatchMode`: an eager op is a launch, so this is the step's
    traffic.  Each op's bytes go to the first of JAX's source tags
    (`roofline/analysis.py: SOURCE_TAGS`) that its open ranges
    (`obs/trace.py`) name, else "other";
  * the step's kernels (K1-K4, K7): by their formulas
    (`roofline/kernels.py`), through `kernels/ops.py: tapped`, whichever
    backend runs them; the ops inside a kernel's body are not counted, so
    a step on ``plain`` (the CPU) and on ``cuda`` costs the same;
  * flops: torch's flop formulas (`torch.utils.flop_counter`, the ones
    `FlopCounterMode` applies), the kernels' formula flops, and one flop
    an output element of every op tagged pointwise: a lower bound, as
    XLA's cost analysis is for the JAX package's ocean cells;
  * collectives: the step's increase of ``halo.ppermute`` and
    ``halo.bytes``;
  * memory: the rank's arguments (geometry, b, tables, state), its output
    (the new state), and the step's peak: the arguments and the most the
    step allocated above them (`torch.cuda.max_memory_allocated` against
    the allocation the step starts from, on the card;
    `torch.distributed._tools.mem_tracker.MemTracker` on the CPU), so that
    what else the process holds does not count.

`launch/dryrun.py` turns the trace into the JAX package's record (its
keys, and a roofline on the H100 model).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --ocean --device cpu
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import subprocess
import time
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .. import tree as T
from ..core import geometry, mesh2d, stepper
from ..distributed.halo import Transport
from ..distributed.ocean import DistributedOcean
from ..kernels import dispatch, ops
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..roofline import analysis
from ..roofline import kernels as rk
from .mesh import MeshSpec, init_fake_group


@dataclasses.dataclass(frozen=True)
class OceanCell:
    name: str
    nx: int
    ny: int
    lx: float
    ly: float
    nl: int
    m_2d: int
    dt: float
    depth: float
    reef: bool = False
    halo_exchange_period: int = 0


OCEAN_CELLS = {
    # 2*320*328 = 209,920 triangles (divisible by 512), 32 layers
    "benchmark": OceanCell("benchmark", 320, 328, 512e3, 512e3, 32, 20,
                           60.0, 50.0),
    # 2*1280*1290 = 3,302,400 triangles, GBR-scale
    "gbr": OceanCell("gbr", 1280, 1290, 2000e3, 2600e3, 20, 20, 45.0,
                     120.0, reef=True),
    # communication-avoiding variant of the benchmark
    "benchmark-ca2": OceanCell("benchmark-ca2", 320, 328, 512e3, 512e3, 32,
                               20, 60.0, 50.0, halo_exchange_period=2),
}


def build_cell(cell: OceanCell, rank: int, n_parts: int,
               transport: Transport, device=None,
               backend: str = "auto") -> DistributedOcean:
    """Rank `rank`'s DistributedOcean of `cell` on `n_parts` ranks, in
    float32 as the JAX package's cell (device None: the card), its kernels
    on ``backend`` (`kernels/dispatch.py`)."""
    m = mesh2d.rect_mesh(cell.nx, cell.ny, cell.lx, cell.ly, jitter=0.2,
                         seed=7)
    if cell.reef:
        bf = mesh2d.reef_bathymetry(0.1 * cell.depth, cell.depth, cell.lx,
                                    cell.ly)
    else:
        bf = mesh2d.shelf_bathymetry(0.3 * cell.depth, cell.depth, cell.lx)
    # the nodes in float32, where the JAX package's cell evaluates b
    geom = geometry.geom2d_from_mesh(m, dtype=torch.float32, device="cpu")
    pts = np.stack([geom.node_x.numpy().ravel(),
                    geom.node_y.numpy().ravel()], axis=1)
    b = bf(pts).reshape(3, m.nt).astype(np.float32)
    cfg = stepper.OceanConfig(
        nl=cell.nl, dt=cell.dt, m_2d=cell.m_2d, coriolis_f=-4e-5,
        eos_kind="jackett", use_gls=True,
        halo_exchange_period=cell.halo_exchange_period, backend=backend)
    return DistributedOcean(m, b, cfg, rank, n_parts, transport,
                            dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# the trace of one rank's step
# ---------------------------------------------------------------------------
# the port's ranges that stand for a JAX source tag (the kernels' ranges,
# ``kops.<op>.<backend>``, stand for the kernel's name)
RANGE_TAGS = {"stage.external_burst": "run_external",
              "stage.turbulence": "gls_step",
              "stage.turbulence_final": "gls_step",
              "stage.horizontal_rhs": "horizontal_advdiff"}

_aten = torch.ops.aten
# aten ops that are no launch and move no data: allocations and reshapes of
# metadata
_NO_TRAFFIC = {_aten.empty, _aten.empty_like, _aten.empty_strided,
               _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
               _aten.set_, _aten.resize_}


def source_tag() -> str:
    """The first of JAX's source tags that the open ranges name, else
    "other"."""
    names = set()
    for r in _trace.open_ranges():
        if r.startswith("kops."):
            names.add(ops.KERNEL[r.split(".")[1]])
        elif r in RANGE_TAGS:
            names.add(RANGE_TAGS[r])
    return next((t for t in analysis.SOURCE_TAGS if t in names), "other")


def _tensors(xs) -> list:
    return [x for x in tree_leaves(xs) if isinstance(x, torch.Tensor)]


class StepCounter(TorchDispatchMode):
    """Counts the bytes, flops and ops of the enclosed eager code into
    `stats`, each op ``ops.weight()`` times (`kernels/ops.py: counted`);
    `kernel` is the ops' tap (`kernels/ops.py: tapped`)."""

    def __init__(self):
        super().__init__()
        self.stats = analysis.HloStats()
        self.n_ops = 0
        self.kernels: Dict[str, dict] = {}
        self._in_body = 0

    def tag(self) -> str:
        """The source tag of the bytes counted now."""
        return source_tag()

    @contextlib.contextmanager
    def kernel(self, name: str, operands):
        cost, w = rk.COST[name](*operands), ops.weight()
        k = self.kernels.setdefault(name, dict(calls=0, bytes=0, flops=0))
        k["calls"] += w
        k["bytes"] += w * cost.bytes
        k["flops"] += w * cost.flops
        self.stats.add_bytes(w * cost.bytes, self.tag())
        self.stats.flops += w * cost.flops
        self._in_body += 1
        try:
            yield
        finally:
            self._in_body -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (self._in_body or func.namespace != "aten" or func.is_view
                or func.overloadpacket in _NO_TRAFFIC):
            return out
        self.count(func, args, kwargs, out, ops.weight())
        return out

    def count(self, func, args, kwargs, out, w: int) -> None:
        """Count one aten op ``w`` times: its operand and result bytes, its
        flops by torch's formulas, and an operation an output element when
        it is pointwise."""
        if not w:
            return
        self.n_ops += w
        self.stats.add_bytes(w * rk.nbytes(*_tensors((args, kwargs)),
                                           *_tensors(out)), self.tag())
        packet = func.overloadpacket
        if packet in flop_registry:
            self.stats.flops += w * flop_registry[packet](*args, **kwargs,
                                                          out_val=out)
        if torch.Tag.pointwise in func.tags:
            self.stats.flops += w * sum(x.numel() for x in _tensors(out))


@dataclasses.dataclass
class StepTrace:
    """What rank 0's counted step paid (see the module docstring)."""
    stats: analysis.HloStats
    n_ops: int
    kernels: Dict[str, dict]
    memory: dict
    partition: dict
    trace_s: float
    device: str
    dtype: str
    step_ms: Optional[list] = None
    card: Optional[dict] = None
    state: Optional[stepper.OceanState] = None   # after the counted step
    hlo_extra: dict = dataclasses.field(default_factory=dict)  # more `hlo` keys


def card_info() -> Optional[dict]:
    """The card's name and power limit as nvidia-smi gives them, or None
    where nvidia-smi cannot be run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None
    name, limit = (x.strip() for x in out.rsplit(",", 1))
    return dict(name=name, power_limit=limit)


def argument_leaves(do: DistributedOcean, st) -> Dict[str, dict]:
    """{name: {"elements", "bytes"}} of rank 0's arguments, in the order
    and with the names of the JAX package's `abstract_args` (geometry, b,
    tables, state)."""
    out = {}
    groups = (("geom", do.geom), ("b", do.b),
              ("tables", (do.tables.send, do.tables.recv)), ("state", st))
    for group, tree in groups:
        for path, x in T.flatten_with_path(tree):
            if group == "tables":     # JAX's HaloTables fields
                path = (("attr", ("send", "recv")[path[0][1]]),) + path[1:]
            out[group + T.keystr(path)] = dict(
                elements=x.numel(), bytes=x.numel() * x.element_size())
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def trace_rank(do: DistributedOcean, device: torch.device,
               time_steps: int = 0) -> StepTrace:
    """One warm-up step of ``do`` from its initial state, then one counted
    step (and ``time_steps`` timed ones, on the card only)."""
    t0 = time.perf_counter()
    step = do.make_step()
    st = step(do.init_state())
    _sync(device)
    args = argument_leaves(do, st)
    reg = _metrics.default()
    c0 = (reg.counter("halo.ppermute").value, reg.counter("halo.bytes").value)
    launches0 = collections.Counter(ops.LAUNCHES)
    counter = StepCounter()
    arg_bytes = sum(a["bytes"] for a in args.values())
    gc.collect()
    if device.type == "cuda":
        start = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        with counter, ops.tapped(counter.kernel):
            new = step(st)
        _sync(device)
        peak = arg_bytes + torch.cuda.max_memory_allocated(device) - start
    else:
        from torch.distributed._tools.mem_tracker import MemTracker
        mt = MemTracker()
        mt.track_external(*_tensors(T.leaves((do.geom, do.b, do.tables, st))))
        with mt, counter, ops.tapped(counter.kernel):
            new = step(st)
        peak = mt.get_tracker_snapshot("peak")[device]["Total"]
    stats = counter.stats
    stats.n_collectives = int(reg.counter("halo.ppermute").value - c0[0])
    stats.coll_bytes = float(reg.counter("halo.bytes").value - c0[1])
    stats.coll_by_kind = {"collective-permute": stats.coll_bytes}
    backend = dispatch.resolve(do.cfg.backend, device).value
    for name, k in counter.kernels.items():
        k["launches"] = ops.LAUNCHES[(name, backend)] - launches0[(name, backend)]
    out_bytes = sum(x.numel() * x.element_size() for x in T.leaves(new))
    memory = dict(argument_bytes=arg_bytes, output_bytes=out_bytes,
                  temp_bytes=max(0, peak - arg_bytes - out_bytes),
                  alias_bytes=0, peak_per_device=int(peak), arguments=args)
    spec = do.spec
    msg = [int(s.shape[-1]) for s in do.tables.send]
    partition = dict(n_own=spec.n_own, n_loc=spec.n_loc,
                     offsets=list(do.tables.offsets), msg=msg,
                     halo_slots=sum(msg))
    trace_s = time.perf_counter() - t0
    counted, step_ms = new, None
    if time_steps:
        if device.type != "cuda":
            raise ValueError("trace_rank: step times are taken on the card")
        step_ms = []
        for _ in range(time_steps):
            t1 = time.perf_counter()
            new = step(new)
            _sync(device)
            step_ms.append((time.perf_counter() - t1) * 1e3)
    return StepTrace(stats=stats, n_ops=counter.n_ops, kernels=counter.kernels,
                     memory=memory, partition=partition, trace_s=trace_s,
                     device=device.type, dtype=analysis.dtype_name(do.dtype),
                     step_ms=step_ms,
                     card=card_info() if device.type == "cuda" else None,
                     state=counted)


def trace_ocean(config: Union[str, OceanCell], spec: MeshSpec, device=None,
                time_steps: int = 0, verbose: bool = False,
                return_state: bool = False, backend: str = "auto"):
    """The dry-run record of rank 0 of ``config`` (a name of `OCEAN_CELLS`
    or an `OceanCell`) on ``spec.size`` ranks, traced on ``device`` (the
    card unless the caller asks for the CPU) on a fake group of that size,
    which it starts and destroys when none is initialized; with
    ``return_state``, (the record, rank 0's state after the counted step),
    so that a trace on one backend can be held against another's.  The
    kernels run on ``backend``; on ``ref`` (the JAX package's formulation)
    nothing runs inside a kernel body, so the record counts the ref ops as
    ordinary ones and only its state is comparable."""
    from . import dryrun
    cell = OCEAN_CELLS[config] if isinstance(config, str) else config
    device = dispatch.default_device(device)
    own = not dist.is_initialized()
    if own:
        init_fake_group(spec.size)
    try:
        if (str(dist.get_backend()).lower() != "fake"
                or dist.get_world_size() != spec.size):
            raise RuntimeError(f"trace_ocean needs a fake group of "
                               f"{spec.size} ranks")
        t0 = time.perf_counter()
        do = build_cell(cell, 0, spec.size, Transport(), device, backend)
        build_s = time.perf_counter() - t0
        traced = trace_rank(do, device, time_steps)
    finally:
        if own:
            dist.destroy_process_group()
    aux = dict(arch=f"ocean-{cell.name}", shape=f"nl{cell.nl}_m{cell.m_2d}",
               n_triangles=cell.nx * cell.ny * 2, n_layers=cell.nl,
               model_flops=0.0, n_params=0, n_params_active=0,
               m_2d=cell.m_2d, halo_exchange_period=cell.halo_exchange_period,
               build_s=round(build_s, 2))
    rec = dryrun.analyze(traced, aux, spec, verbose=verbose)
    return (rec, traced.state) if return_state else rec
