"""The launch plan of the block-Thomas kernel K3
(`repro_torch.kernels.column_solve.launch_plan`), on the CPU.

The CUDA launcher takes its variant, tile width, threads, shared bytes and
grid from Python and refuses any plan it did not build, so they are held
here without a card: the tile fits the shared memory it is given, the
`onchip` variant is taken exactly when some built tile width fits, the
width is the plan's rule (the widest from the dtype's preferred width
down), the grid covers every column, a small `smem_limit` forces the
`global` variant, and the plan takes only the instantiations built.  Whether the kernel computes the right thing through
each plan is held against the plain version by the card tests
(`tests/test_torch_gpu.py`).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import column_solve as cs  # noqa: E402

DTYPES = [torch.float32, torch.float64]
NLS = list(range(1, 161))
NTS = [1, 7, 8, 9, 31, 33, 1007, 160000, 159963]
MAX_THREADS = 1024                  # threads a block can have
SMALL = 20_000                      # below every onchip tile at nl = 16


def _smem(nl, k, tc, dtype, variant):
    rows = (nl if variant == "onchip" else 1) * 6 * (6 + k)
    return rows * tc * dtype.itemsize


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", cs.RHS_WIDTHS)
@pytest.mark.parametrize("nl", NLS)
def test_plan_fits_and_picks_the_rule(nl, k, dtype):
    plan = cs.launch_plan(nl, k, 1007, dtype)
    assert plan["smem"] <= cs.MAX_SMEM
    assert plan["threads"] == 6 * plan["tc"] <= MAX_THREADS
    assert plan["smem"] == _smem(nl, k, plan["tc"], dtype, plan["variant"])
    widths = [tc for tc in cs.TILE_COLS if tc <= cs.PREFERRED_TC[dtype]]
    fits = [tc for tc in widths
            if _smem(nl, k, tc, dtype, "onchip") <= cs.MAX_SMEM]
    if fits:
        assert plan["variant"] == "onchip" and plan["tc"] == fits[0]
        assert plan["scratch"] == 0
    else:
        # no built width fits: the narrowest onchip tile does not
        assert _smem(nl, k, min(cs.TILE_COLS), dtype, "onchip") > cs.MAX_SMEM
        assert plan["variant"] == "global" and plan["tc"] == widths[0]
        assert plan["scratch"] == plan["grid"] * nl * 6 * (6 + k) * plan["tc"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", cs.RHS_WIDTHS)
def test_deepest_onchip_and_first_global(k, dtype):
    """The variant switches once, at the depth where a tile of 8 columns no
    longer fits: 76 layers in float64 and 152 in float32 at k = 2."""
    variants = [cs.launch_plan(nl, k, 1007, dtype)["variant"] for nl in NLS]
    first = variants.index("global") + 1
    assert set(variants[:first - 1]) == {"onchip"}
    assert set(variants[first - 1:]) == {"global"}
    assert _smem(first - 1, k, 8, dtype, "onchip") <= cs.MAX_SMEM \
        < _smem(first, k, 8, dtype, "onchip")
    if k == 2:
        assert first == {torch.float32: 152, torch.float64: 76}[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nt", NTS)
def test_grid_covers_every_column(nt, dtype):
    for nl in (1, 16, 200):
        for k in cs.RHS_WIDTHS:
            plan = cs.launch_plan(nl, k, nt, dtype)
            tc = plan["tc"]
            assert (plan["grid"] - 1) * tc < nt <= plan["grid"] * tc


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", cs.RHS_WIDTHS)
def test_main_path_is_onchip(k, dtype):
    """The step's shape, 16 layers over 160,000 columns, solves on chip."""
    plan = cs.launch_plan(16, k, 160000, dtype)
    assert plan["variant"] == "onchip" and plan["scratch"] == 0
    assert plan["tc"] == cs.PREFERRED_TC[dtype] or k == 4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", cs.RHS_WIDTHS)
def test_small_limit_forces_global(k, dtype):
    plan = cs.launch_plan(16, k, 160000, dtype, smem_limit=SMALL)
    assert plan["variant"] == "global" and plan["smem"] <= SMALL
    assert plan["scratch"] == plan["grid"] * 16 * 6 * (6 + k) * plan["tc"]
    with pytest.raises(ValueError):                  # not even one layer's slot fits
        cs.launch_plan(16, k, 160000, dtype, smem_limit=1000)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_takes_only_built_tiles(dtype):
    """Over every depth, both k and a forcing limit, the plan takes each
    instantiation the C launcher builds, and no other: on chip every width
    up to the dtype's preferred one, the global variant at that width."""
    widest = cs.PREFERRED_TC[dtype]
    taken = set()
    for nl in NLS:
        for k in cs.RHS_WIDTHS:
            for limit in (cs.MAX_SMEM, SMALL):
                plan = cs.launch_plan(nl, k, 1007, dtype, limit)
                assert plan["grid"] == -(-1007 // plan["tc"])
                taken.add((plan["variant"], plan["tc"]))
    assert taken == {("onchip", tc) for tc in cs.TILE_COLS if tc <= widest} \
        | {("global", widest)}


def test_plan_rejects_what_is_not_built():
    with pytest.raises(TypeError):
        cs.launch_plan(16, 2, 128, torch.float16)
    with pytest.raises(ValueError):                  # k = 3 is not built
        cs.launch_plan(16, 3, 128, torch.float32)
    with pytest.raises(ValueError):
        cs.launch_plan(0, 2, 128, torch.float32)
    with pytest.raises(ValueError):
        cs.launch_plan(16, 2, 0, torch.float32)
    with pytest.raises(ValueError):     # the global slot of the widest tile does not fit
        cs.launch_plan(200, 2, 128, torch.float32, smem_limit=6143)
    with pytest.raises(ValueError):                  # grid overflow
        cs.launch_plan(1, 2, 2 ** 31 * 32 + 1, torch.float32)
