"""Data pipelines.

LM side: deterministic token batching from a synthetic stream or a
memory-mapped token file (u16/u32 .bin); resume is exact (the iterator
state is just the step counter).  The token ids are the JAX package's,
drawn by the same numpy calls; each batch is int32 tensors on the
dataset's device.

Ocean side: time-interpolated external forcing (paper §2.5): forcing fields
vary linearly between two precomputed states ~1 h apart; the interpolation
runs on the forcing's device, and a host thread fetches the next window
while the simulation runs in the current one.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import tree as T
from ..kernels.dispatch import default_device


# ---------------------------------------------------------------------------
# LM token pipeline
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TokenDataset:
    """Deterministic token batch source (batches on ``device``: the card
    unless another device is asked for)."""
    vocab: int
    seq_len: int
    global_batch: int
    data: Optional[np.ndarray] = None     # memmap or array of token ids
    seed: int = 0
    device: Any = None

    @classmethod
    def from_file(cls, path: str, vocab: int, seq_len: int,
                  global_batch: int, dtype=np.uint16,
                  device: Any = None) -> "TokenDataset":
        data = np.memmap(path, dtype=dtype, mode="r")
        return cls(vocab=vocab, seq_len=seq_len, global_batch=global_batch,
                   data=data, device=device)

    def batch_at(self, step: int) -> dict:
        """Batch for a given step (resumable by construction)."""
        B, Tn = self.global_batch, self.seq_len
        if self.data is not None:
            n_tok = len(self.data) - (Tn + 1)
            rng = np.random.default_rng(self.seed + step)
            offs = rng.integers(0, n_tok, size=B)
            toks = np.stack([np.asarray(self.data[o:o + Tn + 1],
                                        dtype=np.int32) for o in offs])
        else:
            # synthetic but LEARNABLE: noisy affine bigram process
            # (next = 31*prev+7 mod V with p=0.85, else uniform): a model
            # that learns the bigram reaches ~0.15*log(V) loss
            rng = np.random.default_rng(self.seed + step)
            toks = np.empty((B, Tn + 1), np.int32)
            toks[:, 0] = rng.integers(0, self.vocab, size=B)
            noise = rng.random(size=(B, Tn)) > 0.85
            rand = rng.integers(0, self.vocab, size=(B, Tn), dtype=np.int64)
            for t in range(Tn):
                nxt = (toks[:, t].astype(np.int64) * 31 + 7) % self.vocab
                toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        dev = default_device(self.device)
        return {"tokens": torch.from_numpy(toks[:, :Tn].copy()).to(dev),
                "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


# ---------------------------------------------------------------------------
# Ocean forcing: linear-in-time window interpolation (paper §2.5)
# ---------------------------------------------------------------------------
def interp_forcing(f0: torch.Tensor, f1: torch.Tensor, t0: float, t1: float,
                   t) -> torch.Tensor:
    """Linear interpolation between two forcing states, on their device."""
    w = torch.clamp(torch.as_tensor((t - t0) / (t1 - t0), dtype=f0.dtype,
                                    device=f0.device), 0.0, 1.0)
    return f0 * (1.0 - w) + f1 * w


class ForcingWindow:
    """Holds two forcing states [t0, t1] on ``device``; fetches the next
    window on a host thread when the simulation time enters the current
    one.

    `provider(k)` returns the forcing tree at window index k (e.g. read from
    disk + spatial interpolation); windows are `dt_window` apart.  Its
    tensors are moved to ``device`` (the card unless another device is
    asked for)."""

    def __init__(self, provider: Callable[[int], dict], dt_window: float,
                 prefetch: bool = True, device: Any = None):
        self.device = default_device(device)
        self.provider = provider
        self.dt = dt_window
        self.k0 = 0
        self.f0 = self._fetch(0)
        self.f1 = self._fetch(1)
        self.prefetch = prefetch
        self._next: Optional[Tuple[int, dict]] = None
        self._thread: Optional[threading.Thread] = None

    def _fetch(self, k: int) -> dict:
        return T.map_leaves(
            lambda x: x.to(self.device) if isinstance(x, torch.Tensor) else x,
            self.provider(k))

    def _prefetch(self, k):
        def work():
            self._next = (k, self._fetch(k))
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def at(self, t: float):
        """(f0, f1, t0, t1) for simulation time t, advancing windows."""
        k = int(t // self.dt)
        while k > self.k0:
            if self._thread is not None:
                self._thread.join()
                self._thread = None
            if self._next is not None and self._next[0] == self.k0 + 2:
                nxt = self._next[1]
            else:
                nxt = self._fetch(self.k0 + 2)
            self.f0, self.f1 = self.f1, nxt
            self.k0 += 1
            self._next = None
        if self.prefetch and self._next is None and self._thread is None:
            self._prefetch(self.k0 + 2)
        return self.f0, self.f1, self.k0 * self.dt, (self.k0 + 1) * self.dt


def tidal_forcing_provider(geom, amplitude: float, period: float,
                           phase_fn=None):
    """Synthetic tidal open-boundary elevation provider (GBR example):
    eta_bc(t) sampled at window boundaries, interpolated between them; the
    tensors are on ``geom``'s device."""
    def provider(k):
        t = k * period / 12.0
        ph = 0.0 if phase_fn is None else phase_fn(geom)
        eta = amplitude * np.cos(2 * np.pi * t / period + ph)
        return {"eta_open": torch.as_tensor(
            eta * np.ones((3, geom.nt), np.float32), device=geom.area.device)}
    return provider
