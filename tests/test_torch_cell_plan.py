"""The launch plan of the cell-transpose kernels K5 / K6
(`repro_torch.kernels.cell_transpose.launch_plan`), on the CPU.

The CUDA launcher takes its variant, vector width, accesses per thread,
threads and grid from Python and refuses any other plan, so they are held
here without a card: the vector variant is taken exactly when nt and both
pointers allow 16-byte accesses, an unaligned pointer forces the scalar
one, and the grid has one warp-step for every chunk of every (cell, row)
run.  Which chunk a warp moves is the kernels' own index arithmetic, held
bitwise against the plain versions by the card tests
(`tests/test_torch_gpu.py`, nt = 0-3 mod 4).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import layout  # noqa: E402
from repro_torch.kernels import cell_transpose as ct  # noqa: E402

DTYPES = [torch.float32, torch.float64]
NTS = [1, 127, 128, 129, 4000, 4001, 4002, 4003, 160000, 159963]
ROWS = [6, 18, 96, 384]
BASE = 1 << 40                      # a 16-byte aligned device address
MAX_THREADS = 1024                  # threads a block can have


def _size(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("nt", NTS)
def test_vector_exactly_when_nt_and_pointers_allow(nt, rows, dtype):
    vec = 16 // _size(dtype)
    plan = ct.launch_plan(rows, nt, dtype, BASE, BASE + 4096)
    if nt % vec == 0:
        assert plan["variant"] == "vector" and plan["vec"] == vec
        # the live columns of the last cell are whole vectors
        assert (nt - (layout.num_cells(nt) - 1) * ct.CELL) % vec == 0
    else:
        assert plan["variant"] == "scalar" and plan["vec"] == 1
    assert plan["per_thread"] == ct.PER_THREAD[(plan["variant"], dtype)]
    # bytes each thread has in flight before its first store
    inflight = plan["per_thread"] * plan["vec"] * _size(dtype)
    assert inflight == (128 if plan["variant"] == "vector" else 64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("nt", NTS)
def test_unaligned_pointer_forces_scalar(nt, rows, dtype):
    """A tensor with a storage offset of one element is contiguous but not
    16-byte aligned, on either side of the copy."""
    a = torch.empty(rows * nt + 1, dtype=dtype)[1:]
    assert a.is_contiguous() and a.data_ptr() % ct.ALIGN
    for src, dst in ((a.data_ptr(), BASE), (BASE, a.data_ptr()),
                     (a.data_ptr(), a.data_ptr())):
        plan = ct.launch_plan(rows, nt, dtype, src, dst)
        assert plan["variant"] == "scalar" and plan["vec"] == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nt", NTS)
def test_grid_covers_every_run_once(nt, dtype):
    """Every (cell, row) run is cut into whole chunks, and the grid's blocks
    of warps x per_thread warp-steps hold every chunk, with fewer than one
    block's steps idle: the kernels number the steps 0 .. grid * per_block
    and leave those past the last chunk idle."""
    nc = layout.num_cells(nt)
    for rows in ROWS:
        for aligned in (True, False):
            plan = ct.launch_plan(rows, nt, dtype, BASE,
                                  BASE + (0 if aligned else 4))
            chunk = plan["chunk"]
            assert chunk == ct.WARP * plan["vec"] and ct.CELL % chunk == 0
            assert plan["chunks"] == nc * rows * (ct.CELL // chunk)
            per_block = plan["threads"] // ct.WARP * plan["per_thread"]
            steps = plan["grid"] * per_block
            assert steps - per_block < plan["chunks"] <= steps < ct.MAX_CHUNKS


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_threads_fit_the_launcher(dtype, aligned):
    plan = ct.launch_plan(96, 160000, dtype, BASE, BASE + (0 if aligned else 4))
    assert plan["threads"] == ct.THREADS             # the one block size built
    assert plan["threads"] % ct.WARP == 0 and plan["threads"] <= MAX_THREADS
    assert plan["grid"] * plan["threads"] // ct.WARP * plan["per_thread"] \
        < ct.MAX_CHUNKS


def test_plan_rejects_what_is_not_built():
    with pytest.raises(TypeError):
        ct.launch_plan(6, 128, torch.float16, BASE, BASE)
    with pytest.raises(ValueError):
        ct.launch_plan(0, 128, torch.float32, BASE, BASE)
    with pytest.raises(ValueError):
        ct.launch_plan(6, 0, torch.float32, BASE, BASE)
    with pytest.raises(ValueError):                  # chunk numbers overflow
        ct.launch_plan(6 * 2 ** 20, 2 ** 17, torch.float32, BASE, BASE)
