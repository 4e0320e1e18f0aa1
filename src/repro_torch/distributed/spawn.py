"""Run a function on P ranks, one process each, and never hang.

    results = spawn.run(fn, n_ranks=4, args=(case,), timeout_s=600)

`fn(rank, n_ranks, *args)` runs in P fresh processes (`torch.multiprocessing`
with the spawn method), each after `torch.distributed.init_process_group`
on gloo with a `FileStore` in a temporary directory, so no port is
opened.  `fn` must be importable by module path and its arguments and
result picklable.  Each rank uses one intra-op thread: the ranks share the
host's cores.

The parent returns the ranks' results in rank order.  It never waits past
its deadline: a rank that raises, or dies without a result, or a run that
outlasts `timeout_s` kills every rank and raises in the parent (the rank's
traceback in the message), so a test or a smoke run fails and does not
hang.  The process group's own timeout (`PG_TIMEOUT_S`) ends a collective
that waits on a peer that never answers.
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


def _rank_main(rank: int, n_ranks: int, store_path: str, fn: Callable,
               args: Sequence, results) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, n_ranks)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=n_ranks,
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
        timeout_s: float = 600.0) -> List[Any]:
    """`fn(rank, n_ranks, *args)` on `n_ranks` processes; their results in
    rank order.  Raises RuntimeError when a rank fails, TimeoutError when
    the run outlasts `timeout_s`; every rank is ended either way."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n_ranks, os.path.join(tmp, "store"),
                               fn, tuple(args), results))
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
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
