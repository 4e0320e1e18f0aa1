"""Build, load and call the hand-written CUDA kernels of `csrc/`.

`csrc/ocean_kernels.cu` is compiled with `nvcc` into a shared library with a
plain C interface and loaded with `ctypes`.  The build runs at first use
into `build/kernels/` at the root of the checkout, keyed by a hash of the
source and the flags, so a fresh checkout builds once and later processes
reuse the library.  `nvcc -Xptxas -v` reports each kernel's registers and
spills; the report is kept beside the library (`ptxas_report()`).

The kernels build only in a source checkout (or an editable install):
`csrc/` is not installed as package data, and the build directory lies at
the checkout's root.  Without the source, `build()` raises.

Nothing here runs at import: the CPU tests import every module of the
package on machines with no `nvcc` and no card.  A build or launch failure
raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "ocean_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int64
_ARGTYPES = {
    "solve_r": [_P, _P, _P, _P, _I, _I, _I, _P],
    "solve_w": [_P, _P, _P, _P, _I, _I, _I, _P],
    "block_thomas": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "lateral_flux": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "soa_to_cell": [_P, _P, _I, _I, _P],
    "cell_to_soa": [_P, _P, _I, _I, _P],
    "tridiag": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

_lib = None


def nvcc() -> str:
    """Path of the CUDA compiler: on PATH, else under $CUDA_HOME or the
    toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _key() -> str:
    if not SOURCE.is_file():
        raise RuntimeError(f"kernel source {SOURCE} not found: the CUDA kernels "
                           "build only from a source checkout of the repository")
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"ocean_kernels-{_key()}.so"


def build() -> Path:
    """Compile the kernels unless this source was built already."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n"
                           f"{res.stderr}")
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, so)
    return so


def ptxas_report() -> str:
    """What `-Xptxas -v` printed for the current build."""
    build()
    return library_path().with_suffix(".log").read_text()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _ARGTYPES.items():
            for suffix in _SUFFIX.values():
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.ocean_error_string.argtypes = [ctypes.c_int]
        lib.ocean_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(name: str, t: torch.Tensor, shape, like: torch.Tensor) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``like``'s dtype and
    device with the given shape."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type != "cuda" or t.device != like.device:
        raise ValueError(f"{name}: expected a tensor on {like.device}, "
                         f"got {t.device}")
    if t.dtype not in _SUFFIX or t.dtype != like.dtype:
        raise TypeError(f"{name}: expected {like.dtype} (float32 or float64), "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch(kernel: str, dtype: torch.dtype, device: torch.device,
           *args) -> None:
    """Call the C launcher ``kernel`` for ``dtype`` on the current stream of
    ``device``; raise if the launch was refused."""
    lib = library()
    fn = getattr(lib, f"{kernel}_{_SUFFIX[dtype]}")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*args, stream)
    if err != 0:
        msg = lib.ocean_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {kernel}_{_SUFFIX[dtype]} failed to "
                           f"launch: {msg} ({err})")
