"""The launch plan of the scalar Thomas kernel K7
(`repro_torch.kernels.tridiag.launch_plan`), on the CPU.

The CUDA launcher takes its variant, threads, shared bytes and grid from
Python and refuses any plan it did not build, so they are held here
without a card: the variant follows the depth (``onchip`` while cp and dp
of a block's columns fit a block's shared memory and at least MIN_BLOCKS
such blocks fit an SM, then ``global``), the grid covers every column
once, the shared bytes fit a block's shared memory, only
``global`` allocates a scratch, and the launcher's C signature and
constants match `cuda_lib` and the plan.  Whether the kernel computes the
right thing through each plan is held bitwise against the plain version by
the card tests (`tests/test_torch_gpu.py`).
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels import tridiag as tri  # noqa: E402

DTYPES = [torch.float32, torch.float64]
NLS = list(range(1, 161))
CS = [1, 130, 159963, 160000]
SOURCE = Path(cuda_lib.CSRC) / "ocean_kernels.cu"
# the first depth the plan sends to the global variant (fewer than 4 / 3
# onchip blocks a SM), and the first at which cp and dp of 128 columns no
# longer fit 232,448 bytes
FIRST_GLOBAL = {torch.float32: 57, torch.float64: 38}
PAST_SHARED = {torch.float32: 228, torch.float64: 114}


def _shared(nl, dtype):
    return 2 * nl * tri.THREADS * dtype.itemsize


def _onchip(nl, dtype):
    """Whether the plan takes onchip: its bytes fit, and enough blocks a SM."""
    smem = _shared(nl, dtype)
    return (smem <= tri.MAX_SMEM
            and 233_472 // (smem + 1024) >= tri.MIN_BLOCKS[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_variant_follows_depth(dtype):
    for nl in NLS:
        for C in CS:
            plan = tri.launch_plan(nl, C, dtype)
            onchip = _onchip(nl, dtype)
            assert plan["variant"] == ("onchip" if onchip else "global"), (nl, C)
            assert plan["threads"] == tri.THREADS
            assert plan["smem"] <= tri.MAX_SMEM
            if onchip:
                assert tri.blocks_per_sm(plan) >= tri.MIN_BLOCKS[dtype]
                assert plan["smem"] == _shared(nl, dtype)
                assert plan["scratch"] == 0
            else:
                assert plan["smem"] == 0 and plan["scratch"] == nl * C


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nl", [1, 2, 16, 17, 37, 38, 56, 57, 113, 114, 227,
                                228, 400])
def test_alternatives(nl, dtype):
    """Each variant the launcher takes is listed once, the plan's own
    first: onchip then global where the plan takes onchip, global then
    onchip where onchip fits but too few of its blocks fit an SM, global
    alone past shared memory."""
    plans = tri.alternatives(nl, 1007, dtype)
    assert plans[0] == tri.launch_plan(nl, 1007, dtype)
    variants = [p["variant"] for p in plans]
    if _onchip(nl, dtype):
        assert variants == ["onchip", "global"]
    elif _shared(nl, dtype) <= tri.MAX_SMEM:
        assert variants == ["global", "onchip"]
    else:
        assert variants == ["global"]
    assert len({(p["threads"], p["grid"]) for p in plans}) == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_first_global_depths(dtype):
    """The plan takes global from 57 (float32) / 38 (float64) layers, where
    fewer than 4 / 3 onchip blocks fit an SM, and the launcher takes only
    global from 228 / 114 layers, where 2 nl values a column of 128 columns
    no longer fit a block's shared memory."""
    first, past = FIRST_GLOBAL[dtype], PAST_SHARED[dtype]
    variants = [tri.launch_plan(nl, 160000, dtype)["variant"]
                for nl in range(1, past + 10)]
    assert variants.index("global") + 1 == first
    assert set(variants[first - 1:]) == {"global"}
    lone = [len(tri.alternatives(nl, 160000, dtype)) == 1
            for nl in range(1, past + 10)]
    assert lone.index(True) + 1 == past and all(lone[past - 1:])
    assert _shared(past - 1, dtype) <= tri.MAX_SMEM < _shared(past, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", CS + [127, 128, 129, 2 ** 20 + 3])
def test_grid_covers_every_column_once(C, dtype):
    for nl in (1, 16, 40, 300):
        for plan in tri.alternatives(nl, C, dtype):
            assert (plan["grid"] - 1) * plan["threads"] < C
            assert C <= plan["grid"] * plan["threads"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [159963, 160000])
def test_main_path_keeps_cp_and_dp_on_chip(C, dtype):
    """The step's systems, 16 layers over the mesh's columns, take the
    onchip variant and allocate no scratch."""
    plan = tri.launch_plan(16, C, dtype)
    assert plan["variant"] == "onchip" and plan["scratch"] == 0
    assert plan["smem"] == 16 * 2 * 128 * dtype.itemsize


def test_plan_rejects_what_is_not_built():
    with pytest.raises(TypeError):
        tri.launch_plan(16, 128, torch.float16)
    with pytest.raises(ValueError):
        tri.launch_plan(0, 128, torch.float32)
    with pytest.raises(ValueError):
        tri.launch_plan(16, 0, torch.float32)
    with pytest.raises(ValueError):                  # grid overflow
        tri.launch_plan(1, 2 ** 31 * tri.THREADS + 1, torch.float32)


def _c_params(name: str) -> list:
    """(type, name) of each parameter of the extern "C" launcher ``name``."""
    text = SOURCE.read_text()
    m = re.search(rf"int {name}_##SUFFIX\((.*?)\)\s*{{", text, re.S)
    assert m, name
    params = [p.replace("\\", " ").split() for p in m.group(1).split(",")]
    return [(" ".join(p[:-1]), p[-1]) for p in params]


def test_launcher_arguments_match_cuda_lib():
    """The C launcher's parameters, in order: six pointers, nl and C, the
    onchip flag and the plan's LAUNCH_KEYS, the stream; their ctypes in
    `cuda_lib` follow."""
    params = _c_params("tridiag")
    names = [n.lstrip("*") for _, n in params]
    assert names == ["dl", "d", "du", "b", "x", "cp", "nl", "C", "onchip",
                     *tri.LAUNCH_KEYS, "stream"]
    ctypes_of = {"const void*": cuda_lib.ctypes.c_void_p,
                 "void*": cuda_lib.ctypes.c_void_p,
                 "int64_t": cuda_lib.ctypes.c_int64}
    assert [ctypes_of[t] for t, _ in params] == cuda_lib._ARGTYPES["tridiag"]


def test_constants_match_the_source():
    """THREADS is the block the kernel is built for, and MAX_SMEM the
    opt-in limit K3's plan assumes too."""
    text = SOURCE.read_text()
    assert int(re.search(r"kTriThreads = (\d+);", text).group(1)) == tri.THREADS
    from repro_torch.kernels import column_solve
    assert tri.MAX_SMEM == column_solve.MAX_SMEM
