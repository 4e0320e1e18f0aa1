"""The launch plan of the flash-attention kernel K9
(`repro_torch.kernels.flash_attention.launch_plan`), on the CPU.

The CUDA kernel's tile sizes, column chunks, swizzle and shared-memory bytes
are computed in Python and checked by the C launcher against the kernel it
compiled, so they are held here without a card: that the plan fits the
H100's shared memory, that its chunks and swizzle suit TMA and `wgmma`, and
that the grid covers every query tile, heaviest first.  The `wgmma`
instructions the bf16 kernel issues are generated; the committed header
must be what the generator writes.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402

CSRC = Path(fa.__file__).resolve().parents[1] / "csrc"
DTYPES = [torch.float32, torch.bfloat16]
CASES = [(d, dt) for d in fa.HEAD_DIMS for dt in DTYPES]


def _bytes(dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


@pytest.mark.parametrize("d,dtype", CASES)
def test_plan_fits_shared_memory(d, dtype):
    plan = fa.launch_plan(d, dtype)
    assert 0 < plan["smem_bytes"] <= fa.MAX_SMEM
    bq, bk, st = plan["block_q"], plan["block_k"], plan["stages"]
    # the tiles themselves: Q once, K in every stage, V in every stage
    # (bfloat16) or once (float32)
    v_tiles = st if dtype == torch.bfloat16 else 1
    tiles = _bytes(dtype) * d * (bq + (st + v_tiles) * bk)
    assert plan["smem_bytes"] >= tiles
    assert st >= 2                               # tile t + 1 loads during t


@pytest.mark.parametrize("d,dtype", CASES)
def test_plan_chunks_and_swizzle(d, dtype):
    plan = fa.launch_plan(d, dtype)
    assert (d * _bytes(dtype)) % 16 == 0         # rows of 16-byte units
    if dtype == torch.float32:
        assert plan["chunk"] == 0 and plan["swizzle"] == 0
        return
    cw = plan["chunk"]
    assert d % cw == 0                           # chunks tile the row
    assert (cw * 2) % 16 == 0                    # chunk rows of 16-byte units
    assert plan["swizzle"] == 2 * cw             # one swizzle span per chunk row
    assert plan["swizzle"] in (32, 64, 128)      # TMA / wgmma swizzle modes
    assert 16 % cw == 0 or cw % 16 == 0          # k16 steps stay in a chunk


@pytest.mark.parametrize("d,dtype", CASES)
def test_plan_tiles(d, dtype):
    plan = fa.launch_plan(d, dtype)
    bq, bk, threads = plan["block_q"], plan["block_k"], plan["threads"]
    if dtype == torch.bfloat16:
        assert bq == 128 and threads == 384      # 2 warpgroups + producer
        assert bk % 16 == 0 and bk <= 256        # wgmma k16 steps, N <= 256
        assert d % 16 == 0 or d % 8 == 0         # wgmma N is a multiple of 8
        # float32 accumulators per consumer thread, O (d / 2) and S (bk / 2),
        # within its 240 registers
        assert d // 2 + bk // 2 <= 192
    else:
        assert threads == 256 and bq % 32 == 0 and bk % 8 == 0
        assert d % 8 == 0                        # 8 column groups per row


@pytest.mark.parametrize("tq", [1, 63, 64, 65, 127, 128, 129, 1000, 4096])
@pytest.mark.parametrize("d,dtype", CASES)
def test_grid_covers_every_query_tile(d, dtype, tq):
    plan = fa.launch_plan(d, dtype)
    bq = plan["block_q"]
    nx, bh = fa.grid(plan, 3, tq)
    assert bh == 3 and nx * bq >= tq > (nx - 1) * bq
    order = fa.tile_order(plan, tq)
    assert sorted(order) == list(range(0, nx * bq, bq))
    # heaviest first: under a causal mask a later tile sees more keys
    assert order == sorted(order, reverse=True)
    assert order[0] <= tq - 1 < order[0] + bq


def test_plan_rejects_what_is_not_built():
    with pytest.raises(ValueError):
        fa.launch_plan(96, torch.bfloat16)
    with pytest.raises(TypeError):
        fa.launch_plan(64, torch.float64)


def test_wgmma_header_is_generated():
    spec = importlib.util.spec_from_file_location("gen_wgmma",
                                                  CSRC / "gen_wgmma.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert (CSRC / "wgmma.cuh").read_text() == gen.header()
    # every tile width the plan asks of wgmma is generated
    for d in fa.HEAD_DIMS:
        assert d in gen.RS_N
        assert fa.launch_plan(d, torch.bfloat16)["block_k"] in gen.SS_N
