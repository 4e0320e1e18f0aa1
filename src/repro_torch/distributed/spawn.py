"""Run a function on P ranks, one process each, and never hang.

    results = spawn.run(fn, n_ranks=4, args=(case,), timeout_s=600)

`fn(rank, n_ranks, *args)` runs in P fresh processes (`torch.multiprocessing`
with the spawn method), each after `torch.distributed.init_process_group`
with a `FileStore` in a temporary directory, so no port is opened: on
gloo for ``device="cpu"``; for ``device="cuda"`` every rank computes on
cuda:0 (the ranks share the card, and NCCL refuses two ranks on one
device) over `staged.StagedGroup`, gloo with the collectives gloo refuses
on CUDA tensors staged through the host.  `fn` must be importable by
module path and its arguments and result picklable.  Each rank uses one
intra-op thread: the ranks share the host's cores.

The parent returns the ranks' results in rank order.  It never waits past
its deadline: a rank that raises, or dies without a result, or a run that
outlasts `timeout_s` kills every rank and raises in the parent (the rank's
traceback in the message), so a test or a smoke run fails and does not
hang.  The process group's own timeout (`PG_TIMEOUT_S`) ends a collective
that waits on a peer that never answers.

No rank outlives `run`: a rank still alive when the run ends (at its
deadline, or one that failed) is killed, and `run` waits for each killed
rank to be gone (`KILL_WAIT_S` at most, then it raises), so a loaded host
that is slow to reap a killed process cannot leave one behind.
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

PG_TIMEOUT_S = 120.0
KILL_WAIT_S = 120.0     # how long a killed rank may take to be gone


def _rank_main(rank: int, n_ranks: int, store_path: str, fn: Callable,
               args: Sequence, results, device: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        backend = "gloo"
        if device == "cuda":
            from . import staged
            torch.cuda.set_device(0)
            staged.register()
            backend = staged.NAME
        store = dist.FileStore(store_path, n_ranks)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=n_ranks,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            out = fn(rank, n_ranks, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run(fn: Callable, n_ranks: int, args: Sequence = (),
        timeout_s: float = 600.0, device: str = "cpu") -> List[Any]:
    """`fn(rank, n_ranks, *args)` on `n_ranks` processes; their results in
    rank order.  Raises RuntimeError when a rank fails, TimeoutError when
    the run outlasts `timeout_s`; every rank is ended either way."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"spawn.run: device {device!r} is not cpu or cuda")
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n_ranks, os.path.join(tmp, "store"),
                               fn, tuple(args), results, device))
             for r in range(n_ranks)]
    deadline = time.monotonic() + timeout_s
    got = {}
    try:
        for p in procs:
            p.start()
        while len(got) < n_ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{n_ranks} ranks did not finish in {timeout_s:.0f} s; "
                    f"done: {sorted(got)}")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    # a result sent just before exiting may still be in flight
                    try:
                        rank, ok, out = results.get(timeout=2.0)
                    except queue.Empty:
                        code = procs[dead[0]].exitcode
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{code} and no result") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n_ranks} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
        return [got[r] for r in range(n_ranks)]
    finally:
        killed = [p for p in procs if p.is_alive()]
        for p in killed:
            p.kill()
        for p in killed:
            p.join(timeout=KILL_WAIT_S)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        if alive:
            raise RuntimeError(f"ranks {alive} still alive {KILL_WAIT_S:.0f} s "
                               f"after being killed")
