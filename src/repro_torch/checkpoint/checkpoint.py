"""Checkpointing: async, atomic, verified, and onto any device.

Format (v2), the JAX package's file for file: one directory per step
holding one .npy per tree leaf (path-encoded file names, `tree.key_name`)
and a meta.json with the sorted leaf keys and a per-leaf manifest (crc32
checksum, shape, dtype).  Writes go to a temp dir and then os.rename
(atomic on POSIX); a `latest` file names the newest complete step;
keep_last prunes old steps.  A checkpoint that either framework writes
restores bitwise in the other.

Verification: ``restore`` checks every leaf it loads against the manifest
(checksum + shape + dtype) and, when no explicit step was requested, falls
back to the newest *intact* step: a truncated .npy, a missing leaf, or a
stale/dangling ``latest`` pointer costs one checkpoint interval, not the
run.  v1 checkpoints (no manifest) still restore, unverified.

Failure propagation: the async save worker records any exception and the
next ``wait()``/``save()`` raises it again as ``CheckpointError``.

Devices: the snapshot is copied to the host on the caller thread (on a
CUDA tensor that copy synchronises the stream; on a CPU tensor it is a
copy all the same, since ``.numpy()`` would alias storage that a later
step may change while the worker writes it).  ``restore`` puts each leaf
on one given device, on the device of a matching tree of devices, or by
default on its template leaf's device: a checkpoint written from the card
restores onto the CPU and back.

DTensor leaves (a state laid out on a mesh, `models/sharding`): a leaf is
saved as its global array, JAX's elastic format, so the file is the one a
single device writes and either framework reads.  Every rank gathers each
leaf (the save is a collective, and blocking), rank 0 writes the step,
and the others wait until it has landed; a failed write raises on every
rank.  ``restore`` puts a leaf whose template is a DTensor back on the
template's mesh and placements (JAX's ``restore(..., shardings=)``), each
rank keeping its shard of the array it reads; a plain template leaf
restores onto one device as before.

bfloat16 leaves: numpy has no bfloat16, so a leaf is written as its raw
2-byte elements (numpy's ``V2``), the elements the JAX package's
`np.save` of an ml_dtypes bfloat16 array writes (numpy reads both files
back as ``|V2``), with dtype ``bfloat16`` in the manifest; restore turns
such a file back into a bfloat16 tensor, JAX's files included.

Chaos sites (``runtime/chaos.py``): ``checkpoint.write`` fires inside the
worker before files land; ``checkpoint.saved`` fires after the rename.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import tree as T
from ..launch.mesh import is_dtensor

FORMAT = 2


class CheckpointError(RuntimeError):
    """A checkpoint save failed (possibly on the async worker thread), or a
    checkpoint does not fit the template it is restored into."""


class CheckpointCorruption(CheckpointError):
    """A checkpoint step failed restore-time verification."""


def _flatten(tree) -> Dict[str, Any]:
    return {T.key_name(path): leaf for path, leaf in T.flatten_with_path(tree)}


def _leaf_file(key: str) -> str:
    return key.replace("/", "__") + ".npy"


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _step_name(step: int) -> str:
    return f"step_{step:09d}"


_BF16 = np.dtype("V2")     # a bfloat16 leaf's elements, as raw bytes


def _host_copy(v) -> np.ndarray:
    """A host array that no later write to ``v`` can change."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16)
        return t.numpy()
    return np.array(v)


def _dtype_name(arr: np.ndarray) -> str:
    """The manifest's name of a host array's dtype."""
    return "bfloat16" if arr.dtype == _BF16 else str(arr.dtype)


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return _BF16
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _from_host(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _device_of(leaf) -> torch.device:
    return leaf.device if isinstance(leaf, torch.Tensor) else torch.device("cpu")


def _place(t: torch.Tensor, tmpl, device) -> torch.Tensor:
    """A loaded global array on ``device``, or on the mesh and placements
    of a DTensor template leaf (this rank's shard)."""
    if not is_dtensor(tmpl):
        return t.to(device)
    from ..launch.mesh import shard
    return shard(t, tmpl.device_mesh, tmpl.placements)


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, blocking: bool = False):
        """Snapshot `tree` at `step`; serialisation is async by default.

        Raises ``CheckpointError`` here if the PREVIOUS async save failed:
        the error from the worker thread surfaces at the next save/wait."""
        self.wait()
        flat = _flatten(tree)
        if any(is_dtensor(v) for v in flat.values()):
            return self._save_gathered(step, flat)
        host = {k: _host_copy(v) for k, v in flat.items()}
        self._thread = threading.Thread(target=self._write, args=(step, host),
                                        daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _save_gathered(self, step: int, flat: dict):
        """`save` of a tree with DTensor leaves, on every rank: each leaf
        gathered whole, rank 0 writing, every rank raising if it failed."""
        import torch.distributed as dist
        rank = dist.get_rank()
        host = {}
        for k, v in flat.items():
            whole = v.full_tensor() if is_dtensor(v) else v
            if rank == 0:
                host[k] = _host_copy(whole)
            del whole
        if rank == 0:
            self._write(step, host)
        err = [None if self._error is None else repr(self._error)]
        dist.broadcast_object_list(err, src=0)
        self._error = None
        if err[0] is not None:
            raise CheckpointError(f"checkpoint save on rank 0 failed: {err[0]}")

    def _write(self, step: int, host: dict):
        """Write the host arrays as step ``step`` (atomically); a failure is
        kept for the next `wait`."""
        try:
            from ..runtime import chaos
            chaos.site("checkpoint.write", step=step, directory=self.dir)
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, _step_name(step))
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest: Dict[str, dict] = {}
            for k, v in host.items():
                np.save(os.path.join(tmp, _leaf_file(k)), v)
                manifest[k] = dict(crc32=_crc(v), shape=list(v.shape),
                                   dtype=_dtype_name(v))
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step, "format": FORMAT,
                           "keys": sorted(host.keys()),
                           "leaves": manifest}, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            with open(os.path.join(self.dir, "latest"), "w") as f:
                f.write(os.path.basename(final))
            self._prune()
            chaos.site("checkpoint.saved", step=step, directory=self.dir,
                       path=final)
        except BaseException as e:           # surfaces at next wait()
            self._error = e

    def wait(self):
        """Join any in-flight save; raise its failure as CheckpointError."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointError(
                f"async checkpoint save failed: {err!r}") from err

    def _prune(self):
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for d in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # ---------------------------------------------------------- verification
    def steps(self) -> List[int]:
        """All step numbers with a step directory on disk (ascending)."""
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def manifest(self, step: int) -> Optional[dict]:
        p = os.path.join(self.dir, _step_name(step), "meta.json")
        try:
            with open(p) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def verify(self, step: int) -> List[str]:
        """Problems with the on-disk checkpoint at ``step`` ([] = intact).

        Checks meta.json, leaf presence, checksum, shape and dtype against
        the manifest.  v1 checkpoints (no manifest) only get existence
        checks."""
        d = os.path.join(self.dir, _step_name(step))
        meta = self.manifest(step)
        if meta is None:
            return [f"{_step_name(step)}: missing/unreadable meta.json"]
        problems = []
        leaves = meta.get("leaves", {})
        for k in meta.get("keys", []):
            path = os.path.join(d, _leaf_file(k))
            if not os.path.exists(path):
                problems.append(f"{k}: leaf file missing")
                continue
            try:
                arr = np.load(path)
            except Exception as e:
                problems.append(f"{k}: unreadable ({e})")
                continue
            info = leaves.get(k)
            if info is None:
                continue                       # v1: nothing to check against
            if list(arr.shape) != list(info["shape"]):
                problems.append(f"{k}: shape {list(arr.shape)} != manifest "
                                f"{info['shape']}")
            if _dtype_name(arr) != info["dtype"]:
                problems.append(f"{k}: dtype {arr.dtype} != manifest "
                                f"{info['dtype']}")
            if _crc(arr) != info["crc32"]:
                problems.append(f"{k}: checksum mismatch")
        return problems

    def intact_steps(self) -> List[int]:
        """Steps that pass verification, newest first."""
        return [s for s in reversed(self.steps()) if not self.verify(s)]

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        """Newest step per the ``latest`` pointer, falling back to a
        directory scan when the pointer is missing, stale or dangling."""
        candidates = self.steps()
        p = os.path.join(self.dir, "latest")
        if os.path.exists(p):
            with open(p) as f:
                name = f.read().strip()
            if os.path.exists(os.path.join(self.dir, name, "meta.json")):
                try:
                    pointed = int(name.split("_")[1])
                    # a stale pointer (older than what's on disk) is repaired
                    # by the scan; a fresh one wins
                    if not candidates or pointed >= candidates[-1]:
                        return pointed
                except ValueError:
                    pass
        while candidates:
            s = candidates.pop()
            if os.path.exists(os.path.join(self.dir, _step_name(s),
                                           "meta.json")):
                return s
        return None

    def _load_step(self, step: int, flat: dict, dev_flat: dict) -> dict:
        """Load + verify one step into the template's key set, each leaf on
        its device."""
        d = os.path.join(self.dir, _step_name(step))
        meta = self.manifest(step)
        if meta is None:
            raise CheckpointCorruption(
                f"{_step_name(step)}: missing/unreadable meta.json")
        leaves = meta.get("leaves", {})
        out = {}
        for k, tmpl in flat.items():
            path = os.path.join(d, _leaf_file(k))
            try:
                arr = np.load(path)
            except FileNotFoundError:
                raise CheckpointCorruption(
                    f"{_step_name(step)}: leaf {k!r} missing")
            except Exception as e:
                raise CheckpointCorruption(
                    f"{_step_name(step)}: leaf {k!r} unreadable: {e}")
            info = leaves.get(k)
            if info is not None:
                if list(arr.shape) != list(info["shape"]):
                    raise CheckpointCorruption(
                        f"{_step_name(step)}: leaf {k!r} shape "
                        f"{list(arr.shape)} != manifest {info['shape']}")
                if _dtype_name(arr) != info["dtype"]:
                    raise CheckpointCorruption(
                        f"{_step_name(step)}: leaf {k!r} dtype {arr.dtype} "
                        f"!= manifest {info['dtype']}")
                if _crc(arr) != info["crc32"]:
                    raise CheckpointCorruption(
                        f"{_step_name(step)}: leaf {k!r} checksum mismatch")
            if arr.dtype != _np_dtype(tmpl):
                raise CheckpointError(
                    f"{_step_name(step)}: leaf {k!r} dtype {arr.dtype} != "
                    f"template {_np_dtype(tmpl)}")
            out[k] = _place(_from_host(arr), tmpl, dev_flat[k])
        return out

    def _devices(self, flat: dict, devices: Any) -> dict:
        """Each template key's target device: the one given, the matching
        leaf of a tree of devices, or the template leaf's own."""
        if devices is None:
            return {k: _device_of(v) for k, v in flat.items()}
        if isinstance(devices, (str, torch.device)):
            return {k: torch.device(devices) for k in flat}
        dev_flat = _flatten(devices)
        return {k: torch.device(dev_flat[k]) if k in dev_flat
                else _device_of(v) for k, v in flat.items()}

    def restore(self, template: Any, step: Optional[int] = None,
                devices: Any = None) -> Any:
        """Restore into the structure of `template`, verified.

        ``step=None`` restores the newest INTACT step: corrupt candidates
        are skipped (counted in the default metrics registry) until one
        verifies.  An explicitly requested ``step`` raises
        ``CheckpointCorruption`` instead of silently substituting history.

        devices: one device, or a tree of devices matching the template;
        by default each leaf lands on its template leaf's device (CPU for
        a Python scalar)."""
        flat = _flatten(template)
        dev_flat = self._devices(flat, devices)
        if step is not None:
            candidates = [step]
            fallback = False
        else:
            latest = self.latest_step()
            if latest is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
            candidates = sorted((s for s in self.steps() if s <= latest),
                                reverse=True)
            fallback = True

        last_err: Optional[CheckpointCorruption] = None
        for s in candidates:
            try:
                out = self._load_step(s, flat, dev_flat)
            except CheckpointCorruption as e:
                last_err = e
                if fallback:
                    from ..obs import metrics as obs_metrics
                    obs_metrics.default().counter(
                        "checkpoint.corrupt_skipped").inc()
                    continue
                raise
            return T.unflatten(template, [out[k] for k in flat])
        raise last_err if last_err is not None else FileNotFoundError(
            f"no checkpoint in {self.dir}")

    def restore_latest(self, template: Any, devices: Any = None
                       ) -> Tuple[Any, Optional[int]]:
        """(state, step) from the newest intact checkpoint, or (None, None)
        when nothing on disk is restorable: the runner's cold-restart
        decision point."""
        try:
            latest = self.latest_step()
            if latest is None:
                return None, None
            flat = _flatten(template)
            dev_flat = self._devices(flat, devices)
            for s in sorted((x for x in self.steps() if x <= latest),
                            reverse=True):
                try:
                    out = self._load_step(s, flat, dev_flat)
                except CheckpointCorruption:
                    from ..obs import metrics as obs_metrics
                    obs_metrics.default().counter(
                        "checkpoint.corrupt_skipped").inc()
                    continue
                return T.unflatten(template, [out[k] for k in flat]), s
            return None, None
        except FileNotFoundError:
            return None, None
