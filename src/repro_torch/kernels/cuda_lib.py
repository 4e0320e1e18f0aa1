"""Build, load and call the hand-written CUDA kernels of `csrc/`.

Every source under `csrc/` (`ocean_kernels.cu`: K1-K7 of the ocean step,
`model_kernels.cu`: K8 wkv6, `flash_attention.cu`: K9, with the `wgmma`
instructions of `wgmma.cuh`) is compiled with `nvcc`,
one process per source, all started together, and the objects are linked
into one shared library with a plain C interface, loaded with `ctypes`.
The build runs at first use into `build/kernels/` at the root of the
checkout, keyed by a hash of every source and the flags, so a fresh
checkout builds once and later processes reuse the library (the headers
`csrc/*.cuh` are part of the key).
`nvcc -Xptxas -v` reports each kernel's registers and spills; the report is
kept beside the library (`ptxas_report()`).

The ocean kernels come in float32 and float64, the model kernels in float32
and bfloat16 (`DTYPES`).

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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int64
_ARGTYPES = {
    "solve_r": [_P, _P, _P, _P, _I, _I, _I, _P],
    "solve_w": [_P, _P, _P, _P, _I, _I, _I, _P],
    # ..., k, nl, nt, then the launch plan: onchip, tc, threads,
    # shared-memory bytes, grid (kernels/column_solve.py: launch_plan)
    "block_thomas": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # k, onchip, tc, shared-memory bytes -> tiles one SM holds (no stream)
    "block_thomas_occupancy": [_I, _I, _I, _I, _P],
    "lateral_flux": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # ..., then the launch plan: vec, per_thread, threads, grid
    # (kernels/cell_transpose.py: launch_plan)
    "soa_to_cell": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    "cell_to_soa": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    # dl, d, du, b, x, cp scratch, nl, C, then the launch plan: onchip,
    # threads, shared-memory bytes, grid (kernels/tridiag.py: launch_plan)
    "tridiag": [_P] * 6 + [_I] * 6 + [_P],
    # r, k, v, w, u, out, BH, T, K, V, u's rows H, then the launch plan:
    # rows, cols, block_cols, threads, tile, stages, shared-memory bytes,
    # access bytes, grid (kernels/wkv6.py: launch_plan, LAUNCH_KEYS)
    "wkv6": [_P] * 6 + [_I] * 14 + [_P],
    # K, rows, cols, threads, shared-memory bytes -> blocks one SM holds
    "wkv6_occupancy": [_I, _I, _I, _I, _I, _P],
    # q, k, v, out, m, l (null or the row statistics), BH, Tq, Tk, d, ...,
    # then the launch plan: block_q, block_k, chunk, stages, threads,
    # shared-memory bytes, the grid's query tiles
    # (kernels/flash_attention.py: launch_plan, grid)
    "flash_attention": [_P] * 6 + [_I, _I, _I, _I, ctypes.c_int,
                        _I, ctypes.c_double, ctypes.c_double,
                        _I, _I, _I, _I, _I, _I, _I, _P],
}
OCEAN_DTYPES = (torch.float32, torch.float64)
MODEL_DTYPES = (torch.float32, torch.bfloat16)
# the dtypes each launcher is built for
DTYPES = {name: MODEL_DTYPES if name.startswith(("wkv6", "flash_attention"))
          else OCEAN_DTYPES for name in _ARGTYPES}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}

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


def sources() -> list:
    """Every CUDA source under `csrc/`; raises outside a source checkout."""
    found = sorted(CSRC.glob("*.cu"))
    if not found:
        raise RuntimeError(f"no kernel source under {CSRC}: the CUDA kernels "
                           "build only from a source checkout of the repository")
    return found


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"repro_torch_kernels-{_key()}.so"


def _nvcc(*cmds) -> str:
    """Run the nvcc commands all at once and wait for them; raise if any
    failed, else return what they printed."""
    procs = [subprocess.Popen([nvcc(), *cmd], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for cmd in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}"
                               f"\n{out}\n{err}")
    return "".join(out + err for out, err in outs)


def build() -> Path:
    """Compile the kernels unless these sources were built already: one
    `nvcc -c` per source, all at once, then one link."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    srcs = sources()
    objs = [str(BUILD_DIR / f"{tag}.{src.stem}.o") for src in srcs]
    report = _nvcc(*([*NVCC_FLAGS, "-c", "-o", obj, str(src)]
                     for src, obj in zip(srcs, objs)))
    tmp = BUILD_DIR / f"{tag}.tmp"
    _nvcc(["-shared", "-o", str(tmp), *objs])
    for obj in objs:
        os.unlink(obj)
    so.with_suffix(".log").write_text(report)
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
            for dtype in DTYPES[name]:
                fn = getattr(lib, f"{name}_{_SUFFIX[dtype]}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.ocean_error_string.argtypes = [ctypes.c_int]
        lib.ocean_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(name: str, t: torch.Tensor, shape, like: torch.Tensor,
          dtypes=OCEAN_DTYPES) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``like``'s dtype
    (one of ``dtypes``) and device with the given shape."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type != "cuda" or t.device != like.device:
        raise ValueError(f"{name}: expected a tensor on {like.device}, "
                         f"got {t.device}")
    if t.dtype not in dtypes or t.dtype != like.dtype:
        allowed = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name}: expected {like.dtype} ({allowed}), "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def call(name: str, dtype: torch.dtype, *args) -> None:
    """Call the C function ``name`` for ``dtype``; raise if it returned an
    error."""
    lib = library()
    err = getattr(lib, f"{name}_{_SUFFIX[dtype]}")(*args)
    if err != 0:
        msg = lib.ocean_error_string(err).decode()
        raise RuntimeError(f"CUDA function {name}_{_SUFFIX[dtype]} failed: "
                           f"{msg} ({err})")


def launch(kernel: str, dtype: torch.dtype, device: torch.device,
           *args) -> None:
    """Call the C launcher ``kernel`` for ``dtype`` on the current stream of
    ``device``; raise if the launch was refused."""
    call(kernel, dtype, *args, torch.cuda.current_stream(device).cuda_stream)
