"""One run of a cell on P cards: one rank a card over NCCL, through the
port's distributed step (`repro_torch.distributed.ocean.DistributedOcean`).

    out = ranks.run_cell(workload, seed, seconds, traced, n_ranks, t_start)

The parent starts P processes (`torch.multiprocessing`, spawn), which join
one process group through a `FileStore` in a temporary directory.  Where
the ranks compute (``placement``):

  ``card``    rank r on cuda:r, the group on NCCL (the benchmark's runs);
  ``cpu``     gloo on the host (the CPU tests).

Every rank makes the same inputs from the seed, builds its stripe of the
mesh and its local step (`sides.build_rank`; rank 0 loads the kernel
library first, so that it is built once) and runs the warm steps.  Rank 0
times its last warm step and fixes the window's step count from it,
n = max(``min_steps``, round(seconds / that time)), which it broadcasts
once; every rank then runs n steps back to back, with no collective and
no host sync beyond the program's own.  The host clock runs on rank 0
from the first step's launch to after a `synchronize()` and a barrier;
CUDA events on rank 0's stream time each step.  With ``traced`` every rank
profiles the same warm and traced steps (`harness._traced`), so that the
profiler's cost on the host, which paces the step, falls on every rank
alike: the per-layer metrics read rank 0's trace; the result line's
``busy_s`` and ``window_s`` are the means over the ranks, each rank's
beside them.  Then the owned slots are gathered onto rank 0 (`gather_state`),
the other ranks end, and rank 0 frees the program and runs the plain
reference over the whole mesh on its card (`harness.conclude`).

On the cards each rank is bound, before it starts a thread, to its own
equal block of the host's CPUs (`cpu_blocks`), as ranks a GPU are bound
in a deployment: the host launches most of the step, so a rank whose
thread shares a core with another's runs slow and holds every rank back
through the exchanges.

A run never hangs: a rank that raises or dies, or ranks that outlast the
deadline, end the run; every rank is killed and waited for, and the
parent raises `RankFailure` with the rank's traceback.
"""
from __future__ import annotations

import datetime
import os
import shutil
import statistics
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import compare, harness, inputs, sides

DEADLINE_S = 330.0      # from the run's start, under its 360-s limit
PG_TIMEOUT_S = 120.0    # a collective that waits longer on a peer raises
KILL_WAIT_S = 60.0      # how long a killed rank may take to be gone
MIN_STEPS = 10
PLACEMENTS = ("card", "cpu")


class RankFailure(RuntimeError):
    """A rank raised or died without a result, or the ranks outlasted
    their deadline."""


def cpu_blocks(cpus: Sequence[int], n_ranks: int) -> List[List[int]]:
    """``n_ranks`` equal blocks of the sorted ``cpus`` (the last CPUs left
    over when they do not divide); [] where there are fewer than ranks."""
    cpus, share = sorted(cpus), len(cpus) // n_ranks
    return [cpus[r * share:(r + 1) * share] for r in range(n_ranks)] \
        if share else []


def _bind(rank: int, n_ranks: int) -> None:
    """Bind this process to the rank's block of the CPUs it may use."""
    blocks = cpu_blocks(os.sched_getaffinity(0), n_ranks)
    if blocks:
        os.sched_setaffinity(0, blocks[rank])


def _join(rank: int, n_ranks: int, store_path: str,
          placement: str) -> torch.device:
    """Join the process group; returns the rank's device."""
    kw = {}
    if placement == "card":
        # the ranks share one host: NCCL's bootstrap on the loopback
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend, kw["device_id"] = "nccl", device
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, n_ranks), rank=rank,
        world_size=n_ranks, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S),
        **kw)
    return device


def _rank_main(rank: int, n_ranks: int, store_path: str, placement: str,
               fn: Callable, args: Sequence, conn) -> None:
    marks = [("rank_process", time.perf_counter())]
    torch.set_num_threads(1)
    try:
        # before CUDA, NCCL or the profiler starts a thread: threads
        # inherit the binding
        if placement == "card":
            _bind(rank, n_ranks)
        device = _join(rank, n_ranks, store_path, placement)
        marks.append(("process_group", time.perf_counter()))
        out = fn(rank, n_ranks, device, marks, *args)
    except BaseException:
        conn.send((False, traceback.format_exc()))
        raise
    conn.send((True, out))
    conn.close()
    dist.destroy_process_group()


def spawn(fn: Callable, n_ranks: int, args: Sequence = (),
          placement: str = "card", deadline_s: float = DEADLINE_S,
          t_start: float = None) -> List[Any]:
    """``fn(rank, n_ranks, device, marks, *args)`` on ``n_ranks`` processes
    in one process group (``marks``: when the rank's process started and
    when it joined the group); their results in rank order.  ``fn`` is
    importable by module path, its arguments and result picklable.  Raises
    `RankFailure` when a rank fails or ``deadline_s`` after ``t_start``
    (default: now) passes; no rank outlives the call."""
    if placement not in PLACEMENTS:
        raise ValueError(f"placement {placement!r} is not one of "
                         f"{', '.join(PLACEMENTS)}")
    import torch.multiprocessing as mp
    from multiprocessing import connection
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="bench_ranks_")
    pipes = [ctx.Pipe(duplex=False) for _ in range(n_ranks)]
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n_ranks, os.path.join(tmp, "store"),
                               placement, fn, tuple(args), pipes[r][1]))
             for r in range(n_ranks)]
    deadline = (time.perf_counter() if t_start is None else t_start) \
        + deadline_s
    got = {}
    try:
        for p in procs:
            p.start()
        for _, w in pipes:      # a rank that dies closes its end: EOF here
            w.close()
        waiting = {pipes[r][0]: r for r in range(n_ranks)}
        while waiting:
            left = deadline - time.perf_counter()
            if left <= 0:
                raise RankFailure(
                    f"{n_ranks} ranks did not finish within {deadline_s:.0f}"
                    f" s of the run's start; done: {sorted(got)}")
            for conn in connection.wait(list(waiting), timeout=min(left, 1.0)):
                rank = waiting.pop(conn)
                try:
                    ok, out = conn.recv()
                except EOFError:
                    procs[rank].join(timeout=5.0)
                    raise RankFailure(
                        f"rank {rank} exited with code "
                        f"{procs[rank].exitcode} and no result") from None
                if not ok:
                    raise RankFailure(
                        f"rank {rank} of {n_ranks} failed:\n{out}")
                got[rank] = out
        for p in procs:         # one still tearing down after 30 s is
            p.join(timeout=30.0)   # killed below: its result is in
        return [got[r] for r in range(n_ranks)]
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=KILL_WAIT_S)
        for r, w in pipes:
            r.close()
            w.close()
        shutil.rmtree(tmp, ignore_errors=True)
        _stop_resource_tracker()
        alive = [r for r, p in enumerate(started) if p.is_alive()]
        if alive:
            raise RankFailure(f"ranks {alive} still alive {KILL_WAIT_S:.0f} s "
                              "after being killed")


def _stop_resource_tracker() -> None:
    """End the helper process that the spawn method starts beside the
    ranks (it would end on its own once this process exits), and wait for
    it; the next spawn starts it again.  CPython has no public call for
    this: its private `_stop`, where the version has one."""
    from multiprocessing import resource_tracker
    stop = getattr(getattr(resource_tracker, "_resource_tracker", None),
                   "_stop", None)
    if stop is not None:
        stop()


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             n_ranks: int, t_start: float, placement: str = "card",
             deadline_s: float = DEADLINE_S, overrides: dict = None,
             patch: Callable = None, min_steps: int = MIN_STEPS) -> dict:
    """Run ``workload`` once on ``n_ranks`` ranks and return rank 0's
    result line's object.  ``overrides`` patches the configuration and the
    traffic (the CPU tests' small mesh); ``patch(mods, rank)``, importable
    by module path, is called on every rank with its `sides.rank_modules`
    before anything is built (the tests break the timed path with it)."""
    return spawn(_cell_rank, n_ranks,
                 (workload, seed, seconds, traced, t_start, overrides, patch,
                  min_steps), placement, deadline_s, t_start)[0]


def _load_kernels(rank: int) -> None:
    """The kernel library, built by rank 0 alone into `build/kernels/`."""
    from repro_torch.kernels import cuda_lib
    if rank == 0:
        cuda_lib.library()
    dist.barrier()
    if rank != 0:
        cuda_lib.library()


def _halo_counts() -> tuple:
    from repro_torch.obs import metrics
    reg = metrics.default()
    return (reg.counter("halo.ppermute").value,
            reg.counter("halo.bytes").value)


def _cell_rank(rank: int, n_ranks: int, device: torch.device, marks: list,
               workload: str, seed: int, seconds: float, traced: bool,
               t_start: float, overrides: dict, patch: Callable,
               min_steps: int):
    """One rank's run; rank 0 returns the result line's object."""
    case, traffic, cell, dtype = harness.load(workload, overrides)
    mods = sides.rank_modules()
    if patch is not None:
        patch(mods, rank)
    if device.type == "cuda":
        _load_kernels(rank)
    marks.append(("imports", time.perf_counter()))

    # --- set-up ----------------------------------------------------------
    inp = inputs.make_inputs(case, traffic, seed, device)
    marks.append(("inputs", time.perf_counter()))
    side = sides.build_rank(mods, inp, dtype, device, rank, n_ranks)
    spec = side.ranks.spec
    owned = np.concatenate([spec.glob_ids[r][:spec.n_own]
                            for r in range(n_ranks)])
    if not np.array_equal(owned, np.arange(inp.mesh.nt)):
        raise RuntimeError("the ranks' owned slots are not the mesh's "
                           "triangles in order: a gathered state would be "
                           "compared out of order")
    marks.append(("program", time.perf_counter()))
    st = side.state
    for _ in range(harness.WARM_STEPS):
        t0 = time.perf_counter()
        st = side.advance(st)
        harness.sync(device)
    wire = device if device.type == "cuda" and \
        dist.get_backend() == "nccl" else torch.device("cpu")
    n = torch.tensor([max(min_steps, round(seconds
                                           / (time.perf_counter() - t0)))],
                     device=wire)
    dist.broadcast(n, src=0)
    n = int(n.item())
    dist.barrier()
    marks.append(("warm_steps", time.perf_counter()))
    setup_s = marks[-1][1] - t_start

    # --- the measured window ---------------------------------------------
    halo0 = _halo_counts()
    clock = harness.StepClock(device)
    t0 = time.perf_counter()
    clock.mark()
    for _ in range(n):
        st = side.advance(st)
        clock.mark()
    harness.sync(device)
    dist.barrier()
    wall_s = time.perf_counter() - t0
    halo1 = _halo_counts()
    step_ms = clock.step_ms()
    steps = harness.WARM_STEPS + n
    tr = counts = None
    if traced:
        st, tr, counts = harness._traced(side, st, device)
        steps += 1 + harness.TRACED_STEPS
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = harness.forbidden_modules()
    if found:
        raise RuntimeError(f"rank {rank}: forbidden modules loaded: "
                           f"{', '.join(found)}")

    # --- the owned slots onto rank 0 ---------------------------------------
    glob = side.ranks.gather_state(st, dst=0)
    info = {"peak": peak, "cpus": sorted(os.sched_getaffinity(0)),
            "busy_s": tr.busy_ns() / 1e9 if traced else None,
            "window_s": tr.window_s if traced else None}
    infos = [None] * n_ranks if rank == 0 else None
    dist.gather_object(info, infos, dst=0)
    if rank != 0:
        return {"rank": rank}
    n_offsets = len(side.ranks.tables.offsets)
    period = side.cfg.halo_exchange_period
    prog_fields = compare.fields(glob)
    del side, st, glob
    ctx = {"dtype": case["dtype"], "nl": inp.nl, "nt": spec.n_loc,
           "m_2d": inp.m_2d, "dt": case["dt"], "cell": cell, "steps": n,
           "wall_s": wall_s, "step_ms": step_ms, "trace": tr,
           "launches": counts, "chips": n_ranks,
           "halo": {"shifts": halo1[0] - halo0[0],
                    "bytes": halo1[1] - halo0[1]}}
    peaks = [i["peak"] for i in infos]
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": n_ranks, "memory_peak_bytes": max(peaks),
           "memory_peak_bytes_by_rank": peaks,
           "power_limit_w": (harness.power_limit_w()
                             if device.type == "cuda" else None)}
    if traced:
        for key in ("busy_s", "window_s"):
            dev[key] = statistics.mean(i[key] for i in infos)
            dev[f"{key}_by_rank"] = [i[key] for i in infos]
    out = harness.conclude(workload, inp, dtype, device, prog_fields, steps,
                           ctx, setup_s, marks, t_start, dev)
    checks = out.pop("checks")
    out["ranks"] = {"n": n_ranks, "backend": str(dist.get_backend()),
                    "n_own": spec.n_own, "n_loc": spec.n_loc,
                    "ring_offsets": n_offsets,
                    "halo_shifts_per_step_closed_form":
                        mods.halo.shifts_per_step(n_offsets, period,
                                                  inp.m_2d),
                    "cpus_by_rank": [i["cpus"] for i in infos]}
    out["checks"] = checks
    return out
