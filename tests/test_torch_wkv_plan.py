"""The launch plan of the RWKV6 kernel K8 (`repro_torch.kernels.wkv6`) and
the plain version of its partition, on the CPU.

The CUDA launcher takes the thread tile, block width, threads, time tile,
stages, shared bytes, access width and grid from Python and refuses any plan
it did not build, so they are held here without a card, for every block
width the launcher takes, K in {16, 32, 64}, V from 1 to 200, BH in
{1, 3, 320} and both dtypes: every element of S has exactly one owning
thread, a column's lanes divide the warp, the block fits the card and is
the widest that does, and the access width is legal for V and the
pointers' alignment.

`wkv6_partitioned` computes the recurrence in the kernel's order under a
plan (each lane's partial sums over its rows, the shuffle tree over the
lanes, the bonus as the kernel adds it).  It is held against the plain
version and the JAX Pallas kernel in interpret mode with the tolerances of
`tests/test_torch_model_kernels.py`: float32 within 1e-5 of max(|ref|, 1),
bfloat16 within 2e-2 of each row's largest |ref|.  Whether the kernel
computes the same thing is held by the card tests (`tests/test_torch_gpu.py`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import wkv6 as jwkv6  # noqa: E402
from repro_torch.kernels import wkv6  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16]
BHS = (1, 3, 320)
MAX_THREADS = 1024                  # threads a block can have
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _owners(plan, K: int, V: int) -> np.ndarray:
    """How many threads of the grid of one head hold each (row, column) of
    S, columns padded to whole blocks."""
    nvb = -(-V // plan["block_cols"])
    count = np.zeros((K, nvb * plan["block_cols"]), dtype=np.int64)
    rows = np.array(wkv6.lane_rows(K, plan["rows"]))          # (lanes, R)
    tids = np.arange(plan["threads"])
    g = (tids % 32) % plan["lanes"]
    cols = np.array([wkv6.thread_columns(plan, t) for t in tids])  # (threads, C)
    for b in range(nvb):
        r_idx = rows[g][:, :, None]                           # (threads, R, 1)
        c_idx = (b * plan["block_cols"] + cols)[:, None, :]   # (threads, 1, C)
        np.add.at(count, (np.broadcast_to(r_idx, (len(tids), rows.shape[1], cols.shape[1])),
                          np.broadcast_to(c_idx, (len(tids), rows.shape[1], cols.shape[1]))), 1)
    return count


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", wkv6.HEAD_DIMS)
def test_plan_partitions_and_fits(K, dtype):
    for V in range(1, 201):
        for BH in BHS:
            plans = wkv6.alternatives(BH, K, V, dtype)
            assert dict(plans[0]) == dict(wkv6.launch_plan(BH, K, V, dtype))
            widths = [p["block_cols"] for p in plans]
            assert widths == sorted(set(widths), reverse=True)
            for plan in plans:
                rows, cols, lanes = plan["rows"], plan["cols"], plan["lanes"]
                assert (rows, cols) == wkv6.TILES[dtype]
                assert rows * lanes == K and 32 % lanes == 0 and lanes >= 2
                assert plan["warp_cols"] == 32 // lanes * cols
                assert plan["block_cols"] % plan["warp_cols"] == 0
                assert plan["threads"] == plan["block_cols"] // cols * lanes
                assert plan["threads"] % 32 == 0
                assert plan["threads"] <= min(MAX_THREADS, wkv6.MAX_THREADS)
                assert plan["smem"] == wkv6.smem_bytes(K, plan["block_cols"],
                                                       dtype.itemsize)
                assert plan["smem"] <= wkv6.MAX_SMEM
                assert (plan["tile"], plan["stages"]) == (wkv6.TILE,
                                                          wkv6.STAGES)
                nvb = -(-V // plan["block_cols"])
                assert (nvb - 1) * plan["block_cols"] < V
                assert plan["grid"] == BH * nvb
                # the access width: legal for the dtype and a v row's bytes
                assert plan["bytes"] in (16, 8, 4, 2)
                assert plan["bytes"] >= dtype.itemsize
                assert (V * dtype.itemsize) % plan["bytes"] == 0
            # the plan's block is the widest: one more warp would hold
            # only columns past V, or not fit the block's limits
            top = plans[0]
            wider = top["block_cols"] + top["warp_cols"]
            assert (top["block_cols"] >= V
                    or wider // top["cols"] * top["lanes"] > wkv6.MAX_THREADS
                    or wkv6.smem_bytes(K, wider, dtype.itemsize)
                    > wkv6.MAX_SMEM)
        for plan in wkv6.alternatives(1, K, V, dtype):
            count = _owners(plan, K, V)
            assert (count == 1).all(), plan


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("V", [1, 2, 3, 4, 8, 48, 64, 77, 130, 200])
def test_access_width_follows_alignment(V, dtype):
    """The widest copy the pointers and a v row allow: 16 bytes for aligned
    data whose rows are whole 16-byte pieces, narrower for the rest, and
    element by element (2 bytes) only in bfloat16."""
    isz = dtype.itemsize
    for align in (16, 8, 4, 2):
        if align < isz:
            continue
        b = wkv6.launch_plan(3, 64, V, dtype, align)["bytes"]
        assert b <= align and (V * isz) % b == 0 and b >= isz
        wider = [c for c in (16, 8, 4) if b < c <= align]
        assert all((V * isz) % c for c in wider)
    assert wkv6.alignment(0x1000, 0x1010) == 16
    assert wkv6.alignment(0x1000, 0x1004) == 4
    assert wkv6.alignment(0x1002) == 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_main_path_plan(dtype):
    """rwkv6-3b, BH 320, K = V = 64: the dtype's tile (4 x 8 in float32, 16
    lanes a column; 8 x 4 in bfloat16, 8 lanes), one block of 4 warps a
    head (320 blocks), 16-byte copies; the narrower blocks after it."""
    plan = wkv6.launch_plan(320, 64, 64, dtype)
    tile = {torch.float32: (4, 8, 16), torch.bfloat16: (8, 4, 8)}[dtype]
    assert (plan["rows"], plan["cols"], plan["lanes"]) == tile
    assert plan["block_cols"] == 64 and plan["threads"] == 128
    assert plan["grid"] == 320
    assert plan["bytes"] == 16
    assert [p["block_cols"] for p in wkv6.alternatives(320, 64, 64, dtype)
            ] == [64, 48, 32, 16]


def test_plan_rejects_what_is_not_built():
    with pytest.raises(TypeError):
        wkv6.launch_plan(1, 64, 64, torch.float64)
    with pytest.raises(ValueError):
        wkv6.launch_plan(1, 24, 64, torch.float32)
    with pytest.raises(ValueError):
        wkv6.launch_plan(0, 64, 64, torch.float32)
    with pytest.raises(ValueError):
        wkv6.launch_plan(1, 64, 0, torch.float32)
    with pytest.raises(ValueError):      # no width for 2-byte float32 data
        wkv6.launch_plan(1, 64, 64, torch.float32, 2)


def test_lane_rows_and_columns():
    """Lane g of a column group holds rows 4 L q + 4 g + e; a warp's lanes
    hold 32 / L column groups of C neighbouring columns."""
    assert wkv6.lane_rows(64, 8)[1] == [4, 5, 6, 7, 36, 37, 38, 39]
    assert wkv6.lane_rows(64, 4)[15] == [60, 61, 62, 63]
    rows = wkv6.lane_rows(32, 4)
    assert sorted(sum(rows, [])) == list(range(32)) and len(rows) == 8
    plan = wkv6.launch_plan(320, 64, 64, torch.bfloat16)     # 8 x 4, 8 lanes
    assert wkv6.thread_columns(plan, 0) == [0, 1, 2, 3]
    assert wkv6.thread_columns(plan, 7) == [0, 1, 2, 3]
    assert wkv6.thread_columns(plan, 8) == [4, 5, 6, 7]
    assert wkv6.thread_columns(plan, 32) == [16, 17, 18, 19]
    plan = wkv6.launch_plan(320, 64, 64, torch.float32)      # 4 x 8, 16 lanes
    assert wkv6.thread_columns(plan, 15) == list(range(8))
    assert wkv6.thread_columns(plan, 16) == list(range(8, 16))
    assert wkv6.thread_columns(plan, 32) == list(range(16, 24))


# --- the partition in plain torch against plain and JAX --------------------
def _inputs(seed, bh, t, kd, vd):
    """The recipe of tests/test_kernels.py::test_wkv6_sweep."""
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)
    r, k, v = n(bh, t, kd), n(bh, t, kd), n(bh, t, vd)
    w = np.exp(-np.exp(rng.normal(size=(bh, t, kd)) * 0.5 - 1.0)).astype(np.float32)
    return [r, k, v, w, n(kd)]


def _close(out, exp, dtype):
    out, exp = np.asarray(out, np.float32), np.asarray(exp, np.float32)
    assert out.shape == exp.shape
    err = np.abs(out - exp)
    if dtype == torch.bfloat16:
        limit = TOL[dtype] * np.abs(exp).max(axis=-1, keepdims=True)
    else:
        limit = TOL[dtype] * max(np.abs(exp).max(), 1.0)
    assert (err <= limit).all(), (err.max(), (err - limit).max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kd,vd", [(16, 16), (32, 48), (64, 64), (64, 130)])
def test_partition_vs_pallas_and_plain(kd, vd, dtype):
    """The plan's partition of the same inputs, against the JAX Pallas
    kernel (interpret mode, two time blocks of 128) and the plain version."""
    arrs = _inputs(kd + vd, 2, 256, kd, vd)
    targs = [torch.from_numpy(a).to(dtype) for a in arrs]
    jargs = [jnp.asarray(a).astype(JDT[dtype]) for a in arrs]
    pallas = np.asarray(jnp.asarray(
        jwkv6.wkv6(*jargs, t_block=128, interpret=True), jnp.float32))
    plain = wkv6.wkv6_plain(*targs)
    _close(plain.float(), pallas, dtype)
    out = wkv6.wkv6_partitioned(*targs, wkv6.launch_plan(2, kd, vd, dtype))
    assert out.dtype == dtype and out.shape == (2, 256, vd)
    _close(out.float(), pallas, dtype)
    _close(out.float(), plain.float(), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_partition_ragged(dtype):
    """T = 77 and V = 130 (no multiple of a tile or of the block's columns),
    BH = 1, against the plain version."""
    targs = [torch.from_numpy(a).to(dtype) for a in _inputs(3, 1, 77, 32, 130)]
    plain = wkv6.wkv6_plain(*targs).float()
    plan = wkv6.launch_plan(1, 32, 130, dtype)
    _close(wkv6.wkv6_partitioned(*targs, plan).float(), plain, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_partition_per_head_u(dtype):
    """u (H, K): head bh takes row bh % H in the partition as in plain."""
    arrs = _inputs(9, 6, 40, 64, 48)
    rng = np.random.default_rng(10)
    arrs[4] = (rng.normal(size=(3, 64)) * 0.5).astype(np.float32)
    targs = [torch.from_numpy(a).to(dtype) for a in arrs]
    plain = wkv6.wkv6_plain(*targs).float()
    plan = wkv6.launch_plan(6, 64, 48, dtype)
    _close(wkv6.wkv6_partitioned(*targs, plan).float(), plain, dtype)
