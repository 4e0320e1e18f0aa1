"""Shared benchmark utilities: wall time of a call that ends when the card
has finished its work."""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import tree as T


def block_tree(out):
    """Wait until every tensor leaf of an arbitrary tree is computed:
    synchronise each card that holds one (a CPU tensor is ready when the
    call returns).  Non-tensor leaves (python scalars, None, strings in
    result dicts) are skipped."""
    devices = {leaf.device for leaf in T.leaves(out)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out


class Timing(float):
    """A float (the `reduce` statistic, seconds) carrying the full sample
    spread as attributes: callers keep doing float arithmetic, artifact
    writers pick up p50/p90."""
    p50: float
    p90: float
    min: float
    mean: float
    n: int

    def __new__(cls, primary, samples):
        self = super().__new__(cls, primary)
        s = np.sort(np.asarray(samples, dtype=float))
        self.p50 = float(np.percentile(s, 50))
        self.p90 = float(np.percentile(s, 90))
        self.min = float(s[0])
        self.mean = float(s.mean())
        self.n = int(s.size)
        return self

    def stats(self) -> dict:
        """Plain-dict form for JSON artifact rows (values in seconds)."""
        return {"p50": self.p50, "p90": self.p90, "min": self.min,
                "mean": self.mean, "n": self.n}


def time_fn(fn, *args, warmup=2, iters=5, reduce="median", **kw):
    """Wall time of fn(*args), each call ending in `block_tree`, in seconds.

    Returns a `Timing` (a float subclass): the value is the `reduce`
    statistic, and .p50/.p90/.min/.mean/.n carry the sample spread.

    reduce: "median" (default) or "min"; min is the robust choice on noisy
    shared machines (any sample is an upper bound on the true cost)."""
    if reduce not in ("median", "min"):
        raise ValueError(f"reduce must be 'median' or 'min', got {reduce!r}")
    for _ in range(warmup):
        block_tree(fn(*args, **kw))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block_tree(fn(*args, **kw))
        ts.append(time.perf_counter() - t0)
    primary = float(min(ts) if reduce == "min" else np.median(ts))
    return Timing(primary, ts)
