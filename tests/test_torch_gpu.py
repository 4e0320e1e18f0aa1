"""Card-only tests of the PyTorch port: each CUDA kernel (K1-K9) against its
plain PyTorch version on the card (K3 through both variants and every
tile width its plan takes; K5/K6 bitwise, through both variants and from data that is not
16-byte aligned; K7 bitwise, through both variants, at ragged column counts, either
side of the depths where its plan changes and from data that is not 16-byte
aligned; K8/K9 in
float32 and bfloat16),
the wrappers' input checks, a short step of the cuda backend
against the plain backend, two steps of the small GBR case (every forcing
term) through cuda against plain, a per-call step against a fused one, and
the step boundary with its dispatch counts, and the resilient campaign
(two fault-free legs bitwise, a cuda -> CPU -> cuda restore bitwise, a
poisoned leg bitwise to the fault-free one), the external burst's CUDA
graph bitwise against the host's loop, and the ocean dry run's record
of a small cell on the card against its record on the CPU.

Run on a machine with a CUDA card (no JAX needed):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Each test decides inside itself whether a card is present and skips
otherwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import gbr_reef, quickstart  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.chaos_smoke import bitwise_equal  # noqa: E402
from repro_torch.checkpoint.checkpoint import Checkpointer  # noqa: E402
from repro_torch.core import stepper  # noqa: E402
from repro_torch.kernels import (cell_transpose, column_solve, cuda_lib,  # noqa: E402
                                 dispatch, flash_attention, horizontal_flux,
                                 matrix_free, ops, tridiag, wkv6)
from repro_torch.launch import sim_campaign  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.runtime import chaos  # noqa: E402
from repro_torch.runtime.fault_tolerance import RunnerConfig  # noqa: E402

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.float64]
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(dev, dtype, *arrs):
    return [torch.as_tensor(a).to(device=dev, dtype=dtype) for a in arrs]


def _close(out, ref, dtype):
    scale = max(float(ref.abs().max()), 1.0)
    err = float((out - ref).abs().max())
    assert err <= TOL[dtype] * scale, (err, scale)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nl", [1, 3])
def test_matrix_free_kernels(cuda, dtype, nl):
    rng = np.random.default_rng(nl)
    K, nt = 2, 200
    F, bc = rng.normal(size=(K, nl, 6, nt)), rng.normal(size=(K, 3, nt))
    area = 0.5 + rng.random(nt)
    F, area, bc = _on(cuda, dtype, F, area, bc)
    _close(matrix_free.solve_r(F, area, bc), matrix_free.solve_r_plain(F, area, bc),
           dtype)
    _close(matrix_free.solve_w(F, area, bc), matrix_free.solve_w_plain(F, area, bc),
           dtype)
    _close(matrix_free.solve_w(F, area), matrix_free.solve_w_plain(F, area), dtype)
    torch.cuda.synchronize()


def _thomas_inputs(dev, dtype, nl, k, nt, seed):
    rng = np.random.default_rng(seed)
    lo, dg, up = (0.1 * rng.normal(size=(nl, 6, 6, nt)) for _ in range(3))
    lo[0] = 0.0
    up[-1] = 0.0
    dg += 2.0 * np.eye(6)[None, :, :, None]
    rhs = rng.normal(size=(k, nl, 6, nt))
    return _on(dev, dtype, lo, dg, up, rhs)


def _first_global(k, dtype) -> int:
    """The shallowest depth that the plan sends to the global variant."""
    nl = 16
    while column_solve.launch_plan(nl, k, 1, dtype)["variant"] == "onchip":
        nl += 1
    return nl


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", column_solve.RHS_WIDTHS)
@pytest.mark.parametrize("nt", [200, 1007])
@pytest.mark.parametrize("depth", [1, 3, 16, "deepest onchip", "first global"])
def test_block_thomas_kernel(cuda, dtype, depth, nt, k):
    """Through the plan's variant, at nt = 1,007 (a ragged last tile at
    every tile width) and at the two depths where the variant changes."""
    first = _first_global(k, dtype)
    nl = {"deepest onchip": first - 1, "first global": first}.get(depth, depth)
    lo, dg, up, rhs = _thomas_inputs(cuda, dtype, nl, k, nt, 10 * nl + k)
    plan = column_solve.launch_plan(nl, k, nt, dtype)
    assert plan["variant"] == ("global" if nl >= first else "onchip")
    _close(column_solve.block_thomas(lo, dg, up, rhs),
           column_solve.block_thomas_plain(lo, dg, up, rhs), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", column_solve.RHS_WIDTHS)
def test_block_thomas_forced_global(cuda, dtype, k):
    """nl = 16 through the global variant, forced by a small smem_limit."""
    lo, dg, up, rhs = _thomas_inputs(cuda, dtype, 16, k, 1007, 7 + k)
    assert column_solve.launch_plan(16, k, 1007, dtype, 20_000)["variant"] \
        == "global"
    _close(column_solve.block_thomas(lo, dg, up, rhs, smem_limit=20_000),
           column_solve.block_thomas_plain(lo, dg, up, rhs), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("k", column_solve.RHS_WIDTHS)
@pytest.mark.parametrize("dtype,tc", [
    (dt, tc) for dt in DTYPES for tc in column_solve.TILE_COLS
    if tc <= column_solve.PREFERRED_TC[dt]])
def test_block_thomas_every_width(cuda, dtype, tc, k):
    """Every onchip tile width the plan takes, at the deepest column it
    takes that width for."""
    nl = max(n for n in range(1, _first_global(k, dtype))
             if column_solve.launch_plan(n, k, 1007, dtype)["tc"] == tc)
    lo, dg, up, rhs = _thomas_inputs(cuda, dtype, nl, k, 1007, tc + k)
    _close(column_solve.block_thomas(lo, dg, up, rhs),
           column_solve.block_thomas_plain(lo, dg, up, rhs), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nl,k", [(1, 2), (3, 4)])
def test_lateral_flux_kernel(cuda, dtype, nl, k):
    rng = np.random.default_rng(100 + 10 * nl + k)
    nt = 200
    f = rng.normal(size=(k, nl, 6, nt))
    fext = rng.normal(size=(k, nl, 3, 2, 2, nt))
    speed = rng.normal(size=(nl, 2, 3, 2, nt))
    elen = 0.5 + rng.random((3, nt))
    f, fext, speed, elen = _on(cuda, dtype, f, fext, speed, elen)
    _close(horizontal_flux.lateral_flux(f, fext, speed, elen),
           horizontal_flux.lateral_flux_plain(f, fext, speed, elen), dtype)
    torch.cuda.synchronize()


def test_wrappers_reject_bad_inputs(cuda):
    F = torch.zeros((1, 2, 6, 8), device=cuda)
    area = torch.ones(8, device=cuda)
    with pytest.raises(TypeError):
        matrix_free.solve_w(F, area.double())
    with pytest.raises(ValueError):                  # not contiguous
        matrix_free.solve_w(torch.zeros((1, 2, 8, 6), device=cuda)
                            .transpose(-1, -2), area)
    with pytest.raises(ValueError):
        matrix_free.solve_w(F, area[:4])
    with pytest.raises(ValueError):
        matrix_free.solve_w(F, area.cpu())
    blk = torch.zeros((2, 6, 6, 8), device=cuda)
    with pytest.raises(ValueError):                  # k = 3 is not built
        column_solve.block_thomas(blk, blk, blk, torch.zeros((3, 2, 6, 8),
                                                             device=cuda))


def test_step_cuda_matches_plain(cuda):
    geom, vg, cfg, st = quickstart.setup(nx=12, nl=4, dtype=torch.float64,
                                         device=cuda)
    ops.reset_launches()
    a = stepper.step(geom, vg, cfg, st)
    assert dict(ops.LAUNCHES) == {("solve_r", "cuda"): 2, ("solve_w", "cuda"): 2,
                                  ("block_thomas", "cuda"): 2,
                                  ("lateral_flux", "cuda"): 4,
                                  ("tridiag", "cuda"): 4}
    b = stepper.step(geom, vg, dataclasses.replace(cfg, backend="plain"), st)
    assert dispatch.resolve(cfg.backend, cuda) is dispatch.Backend.CUDA
    for name in ("ux", "uy", "T", "S", "nu_t"):
        _close(getattr(a, name), getattr(b, name), torch.float64)
    assert float(a.ux.abs().max()) > 0.0


# the step's kernel launches a step (chip_smoke.py PER_STEP)
PER_STEP = {"solve_r": 2, "solve_w": 2, "block_thomas": 2, "lateral_flux": 4,
            "tridiag": 4}
# cuda vs plain after whole float64 steps, of each field's own maximum
# (chip_smoke.py TOL_PATH[float64])
TOL_PATH_F64 = 1e-8


def _gbr_small(dev):
    """The CPU test's GBR case (tests/test_torch_gbr.py): rect_mesh(8, 5),
    nl 3, m_2d 4, with a cross-shelf temperature front."""
    geom, vg, cfg, st, forcing_at = gbr_reef.setup(
        nx=8, ny=5, nl=3, m_2d=4, dtype=torch.float64, device=dev)
    front = torch.tanh((geom.node_x - 40e3) / 10e3)
    T = (24.0 + 2.0 * torch.cat([front, front]))[None].expand(st.T.shape)
    return geom, vg, cfg, dataclasses.replace(st, T=T.contiguous()), forcing_at


def _steps(geom, vg, cfg, st, forcing_at, n):
    for _ in range(n):
        st = stepper.step(geom, vg, cfg, st, forcing_at(st.time))
    return st


def test_gbr_steps_cuda_match_plain(cuda):
    geom, vg, cfg, st, forcing_at = _gbr_small(cuda)
    ops.reset_launches()
    a = _steps(geom, vg, cfg, st, forcing_at, 2)
    assert dict(ops.LAUNCHES) == {(op, "cuda"): 2 * n
                                  for op, n in PER_STEP.items()}
    b = _steps(geom, vg, dataclasses.replace(cfg, backend="plain"), st,
               forcing_at, 2)
    for name in ("ux", "uy", "T", "S", "turb_k", "turb_eps", "nu_t",
                 "kappa_t"):
        x, y = getattr(a, name), getattr(b, name)
        assert bool(torch.isfinite(x).all()), name
        err = float((x - y).abs().max()) / max(float(x.abs().max()), 1e-30)
        assert err <= TOL_PATH_F64, (name, err)
    err = float((a.ext.eta - b.ext.eta).abs().max())
    assert err <= TOL_PATH_F64 * float(a.ext.eta.abs().max()), err
    assert float(a.ux.abs().max()) > 0.0


def test_per_call_step_matches_fused_cuda(cuda):
    """One per-call cuda step (fused_horizontal=False: no lateral-flux
    launch) against one fused cuda step, within 1e-11 * max(|x|, 1)."""
    geom, vg, cfg, st, forcing_at = _gbr_small(cuda)
    st = _steps(geom, vg, cfg, st, forcing_at, 1)
    ops.reset_launches()
    a = _steps(geom, vg, dataclasses.replace(cfg, fused_horizontal=False), st,
               forcing_at, 1)
    assert dict(ops.LAUNCHES) == {(op, "cuda"): n for op, n in PER_STEP.items()
                                  if op != "lateral_flux"}
    b = _steps(geom, vg, cfg, st, forcing_at, 1)
    for name in ("ux", "uy", "T", "S", "turb_k", "turb_eps", "nu_t",
                 "kappa_t"):
        x, y = getattr(a, name), getattr(b, name)
        err = float((x - y).abs().max())
        assert err <= 1e-11 * max(float(y.abs().max()), 1.0), (name, err)
    assert float((a.ext.eta - b.ext.eta).abs().max()) <= 1e-11


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nt", [1, 2, 127, 128, 129, 130, 300, 1000, 1003])
@pytest.mark.parametrize("nl", [1, 3, 16, 64])
def test_cell_transpose_kernels(cuda, dtype, nl, nt):
    """nt = 0, 1, 2, 3 (mod 4): the vector variant where nt is a whole
    number of 16-byte vectors, the scalar one elsewhere."""
    rng = np.random.default_rng(nl * 1000 + nt)
    (x,) = _on(cuda, dtype, rng.normal(size=(nl, 6, nt)))
    c = cell_transpose.soa_to_cell(x)
    ref = cell_transpose.soa_to_cell_plain(x)
    assert c.shape == ref.shape and torch.equal(c, ref)      # pad lanes zero
    # K6 ignores whatever the pad lanes hold
    c_dirty = c.clone()
    c_dirty[-1, :, nt - (c.shape[0] - 1) * 128:] = float("nan")
    back = cell_transpose.cell_to_soa(c_dirty, nt)
    assert torch.equal(back, cell_transpose.cell_to_soa_plain(c, nt))
    assert torch.equal(back, x)
    torch.cuda.synchronize()


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data is not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nt", [128, 1000, 1003])
@pytest.mark.parametrize("nl", [1, 16])
def test_cell_transpose_unaligned_pointers(cuda, dtype, nl, nt):
    """Inputs with a storage offset of one element take the scalar variant
    and stay bitwise equal to the plain versions."""
    rng = np.random.default_rng(nl * 1000 + nt + 7)
    (x,) = _on(cuda, dtype, rng.normal(size=(nl, 6, nt)))
    xu = _unaligned(x)
    assert xu.is_contiguous() and xu.data_ptr() % cell_transpose.ALIGN
    c = cell_transpose.soa_to_cell(xu)
    plan = cell_transpose.launch_plan(nl * 6, nt, dtype, xu.data_ptr(),
                                      c.data_ptr())
    assert plan["variant"] == "scalar"
    assert torch.equal(c, cell_transpose.soa_to_cell_plain(x))
    cu = _unaligned(c)
    back = cell_transpose.cell_to_soa(cu, nt)
    plan = cell_transpose.launch_plan(nl * 6, nt, dtype, cu.data_ptr(),
                                      back.data_ptr())
    assert plan["variant"] == "scalar"
    assert torch.equal(back, cell_transpose.cell_to_soa_plain(c, nt))
    assert torch.equal(back, x)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES)
def test_cell_transpose_launcher_refuses_other_plans(cuda, dtype):
    """The C launcher takes only the plan it builds for these rows, nt and
    pointers: the scalar plan on aligned data, the vector plan on unaligned
    data, another grid or block size are refused before any launch."""
    rows, nt = 12, 1000
    x = torch.zeros((rows // 6, 6, nt), dtype=dtype, device=cuda)
    out = torch.empty((8, rows, 128), dtype=dtype, device=cuda)
    xu = _unaligned(x)
    vec = cell_transpose.launch_plan(rows, nt, dtype, x.data_ptr(),
                                     out.data_ptr())
    sca = cell_transpose.launch_plan(rows, nt, dtype, xu.data_ptr(),
                                     out.data_ptr())
    assert vec["variant"] == "vector" and sca["variant"] == "scalar"
    keys = ("vec", "per_thread", "threads", "grid")
    bad = [(x, sca), (xu, vec), (x, dict(vec, grid=vec["grid"] + 1)),
           (x, dict(vec, threads=128)), (x, dict(vec, per_thread=4))]
    for src, plan in bad:
        with pytest.raises(RuntimeError):
            cuda_lib.launch("soa_to_cell", dtype, cuda, src.data_ptr(),
                            out.data_ptr(), rows, nt, *(plan[k] for k in keys))
    cuda_lib.launch("soa_to_cell", dtype, cuda, x.data_ptr(), out.data_ptr(),
                    rows, nt, *(vec[k] for k in keys))
    assert torch.equal(out, cell_transpose.soa_to_cell_plain(x))


def _tridiag_args(dev, dtype, nl, C, seed, offset=0):
    """dl, d, du, b (nl, C) on the card, shaped like GLS's diffusion systems
    but with dl[0] and du[nl-1] not zero; ``offset`` elements past the start
    of their buffers (1: not 16-byte aligned)."""
    rng = np.random.default_rng(seed)
    lo, up = -5.0 * rng.random((nl, C)), -5.0 * rng.random((nl, C))
    lo[0] = rng.normal(size=C)                       # multiplies a zero carry
    up[-1] = rng.normal(size=C)                      # multiplies a zero carry
    d = 1.0 - lo - up
    d[0] = 1.0 - up[0] if nl > 1 else 1.0
    d[-1] = 1.0 - lo[-1] if nl > 1 else 1.0
    b = rng.normal(size=(nl, C))
    out = []
    for a in _on(dev, dtype, lo, d, up, b):
        buf = torch.empty(a.numel() + offset, dtype=dtype, device=dev)
        t = buf[offset:].view(a.shape)
        t.copy_(a)
        out.append(t)
    return out


# nl from 1 past the window of 4 layers (5, 16, 17: a ragged last window);
# C ragged (130, 300, 1003) and whole blocks (128, 1024)
TRIDIAG_SHAPES = [(1, 1), (2, 130), (4, 128), (5, 300), (16, 300), (16, 1000),
                  (17, 1003), (33, 1024), (64, 300)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("nl,C", TRIDIAG_SHAPES)
def test_tridiag_kernel(cuda, dtype, offset, nl, C):
    """Both plans the launcher takes for the shape (the plan's own first,
    the other forced through plan=) equal the plain version bitwise: the
    kernel computes thomas_solve's operations in its order."""
    args = _tridiag_args(cuda, dtype, nl, C, nl * 7 + C, offset)
    ref = tridiag.tridiag_plain(*args)
    plans = tridiag.alternatives(nl, C, dtype)
    assert plans[0] == tridiag.launch_plan(nl, C, dtype)
    for plan in plans:
        out = tridiag.tridiag(*args, plan=plan)
        assert torch.equal(out, ref), (dict(plan), float((out - ref).abs().max()))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES)
def test_tridiag_deep_columns(cuda, dtype):
    """Either side of the depth where the plan turns to the global variant,
    and of the depth past which onchip no longer fits shared memory, through
    every plan the launcher takes, bitwise."""
    first = next(nl for nl in range(16, 1000)
                 if tridiag.launch_plan(nl, 257, dtype)["variant"] == "global")
    past = next(nl for nl in range(first, 1000)
                if len(tridiag.alternatives(nl, 257, dtype)) == 1)
    assert tridiag.launch_plan(first - 1, 257, dtype)["variant"] == "onchip"
    for nl in (first - 1, first, past - 1, past):
        args = _tridiag_args(cuda, dtype, nl, 257, nl)
        ref = tridiag.tridiag_plain(*args)
        for plan in tridiag.alternatives(nl, 257, dtype):
            out = tridiag.tridiag(*args, plan=plan)
            assert torch.equal(out, ref), (nl, dict(plan))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES)
def test_tridiag_launcher_refuses_other_plans(cuda, dtype):
    """The C launcher takes only a plan it builds: shared bytes exactly for
    the onchip variant's cp and dp, a scratch exactly for the global
    variant, 128 threads and the grid that covers C; anything else is
    refused before a launch."""
    nl, C = 12, 300
    args = _tridiag_args(cuda, dtype, nl, C, 5)
    x = torch.empty_like(args[0])
    cp_buf = torch.empty(nl * C, dtype=dtype, device=cuda)
    scratch = cp_buf.data_ptr()
    onchip, glob = tridiag.alternatives(nl, C, dtype)

    def launch(plan, cp=None, flag=None):
        cuda_lib.launch("tridiag", dtype, cuda, *(a.data_ptr() for a in args),
                        x.data_ptr(), cp, nl, C,
                        int(plan["variant"] == "onchip") if flag is None else flag,
                        *(plan[k] for k in tridiag.LAUNCH_KEYS))

    bad = [(dict(onchip, smem=onchip["smem"] - 8), None, None),
           (dict(onchip, smem=onchip["smem"] + 8), None, None),
           (onchip, scratch, None),              # a scratch it does not use
           (glob, None, None),                   # the global variant's scratch
           (dict(glob, smem=onchip["smem"]), scratch, None),
           (onchip, None, 2),                    # not a variant
           (dict(onchip, grid=onchip["grid"] + 1), None, None),
           (dict(glob, grid=onchip["grid"] - 1), scratch, None),
           (dict(onchip, threads=256), None, None)]
    for plan, cp, flag in bad:
        with pytest.raises(RuntimeError):
            launch(plan, cp, flag)
    ref = tridiag.tridiag_plain(*args)
    for plan, cp in ((onchip, None), (glob, scratch)):
        launch(plan, cp)
        assert torch.equal(x, ref), plan["variant"]


def test_new_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros((2, 6, 130), device=cuda)
    with pytest.raises(TypeError):                   # not float32 / float64
        cell_transpose.soa_to_cell(x.half())
    with pytest.raises(ValueError):                  # on the CPU
        cell_transpose.soa_to_cell(x.cpu())
    with pytest.raises(ValueError):                  # not (nl, 6, nt)
        cell_transpose.soa_to_cell(torch.zeros((2, 5, 130), device=cuda))
    with pytest.raises(ValueError):                  # not contiguous
        cell_transpose.soa_to_cell(torch.zeros((2, 130, 6), device=cuda)
                                   .transpose(1, 2))
    c = torch.zeros((2, 12, 128), device=cuda)
    with pytest.raises(ValueError):                  # nt does not fit 2 cells
        cell_transpose.cell_to_soa(c, 300)
    with pytest.raises(ValueError):
        cell_transpose.cell_to_soa(torch.zeros((2, 12, 64), device=cuda), 100)
    with pytest.raises(TypeError):
        cell_transpose.cell_to_soa(c.to(torch.int32), 200)
    a = torch.ones((4, 50), device=cuda)
    with pytest.raises(TypeError):                   # mixed dtypes
        tridiag.tridiag(a, a.double(), a, a)
    with pytest.raises(ValueError):                  # mismatched shapes
        tridiag.tridiag(a, a, a[:, :10], a)
    with pytest.raises(ValueError):                  # nl < 1
        z = torch.zeros((0, 50), device=cuda)
        tridiag.tridiag(z, z, z, z)
    with pytest.raises(ValueError):                  # one operand on the CPU
        tridiag.tridiag(a, a, a, a.cpu())


def test_step_boundary_and_dispatch_counts(cuda):
    """state_to_cell -> state_from_cell through the kernels is bitwise, and
    every cuda dispatch the registry counts launched one kernel."""
    geom, vg, cfg, st = quickstart.setup(nx=12, nl=4, dtype=torch.float64,
                                         device=cuda)
    metrics.reset()
    ops.reset_launches()
    st = stepper.step(geom, vg, cfg, st)
    cells = stepper.state_to_cell(st, backend="cuda")
    back = stepper.state_from_cell(st, cells, geom.nt, backend="cuda")
    for name in ("ux", "uy", "T", "S"):
        assert torch.equal(getattr(back, name), getattr(st, name))
    launches = dict(ops.LAUNCHES)
    assert launches[("soa_to_cell", "cuda")] == 4
    assert launches[("cell_to_soa", "cuda")] == 4
    counted = {}
    for op, kernel in ops.KERNEL.items():
        n = metrics.default().counter("kernel_dispatch", op=op,
                                      backend="cuda").value
        if n:
            counted[(kernel, "cuda")] = counted.get((kernel, "cuda"), 0) + n
    assert counted == launches
    metrics.reset()


# --- model kernels: K8 wkv6, K9 flash attention -------------------------------
# float32: 1e-5 of max(|plain|, 1), the same sums in another order; bfloat16:
# 2e-2 of the largest |plain| of each output row (one query or token of one
# head), since bf16 rounds q * scale, p, k v^T, u k v^T and the output at
# other places, and attention rows over many keys are small
MODEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _model_close(out, ref, dtype):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    ref = ref.float()
    err = (out.float() - ref).abs()
    if dtype == torch.bfloat16:
        limit = MODEL_TOL[dtype] * ref.abs().amax(dim=-1, keepdim=True)
    else:
        limit = MODEL_TOL[dtype] * max(float(ref.abs().max()), 1.0)
    assert bool((err <= limit).all()), (float(err.max()),
                                        float((err - limit).max()))


def _wkv6_args(dev, dtype, bh, t, kd, vd, seed, heads=None):
    """r, k, v, w, u on the card; u is (kd,), or (heads, kd) per head."""
    rng = np.random.default_rng(seed)
    n = lambda *s: 0.5 * rng.normal(size=s)
    w = np.exp(-np.exp(rng.normal(size=(bh, t, kd)) * 0.5 - 1.0))
    u = n(kd) if heads is None else n(heads, kd)
    return _on(dev, dtype, n(bh, t, kd), n(bh, t, kd), n(bh, t, vd), w, u)


# K = 16 and V not a multiple of the block's columns (130, 48), T not a
# multiple of the time tile (77, 200), BH = 1, V = 77 (bfloat16 rows only
# 2-byte aligned: copied element by element), T = V = 1
WKV_SHAPES = [(1, 128, 16, 16), (3, 200, 32, 48), (2, 256, 64, 64),
              (2, 77, 64, 130), (1, 77, 16, 130), (3, 200, 64, 48),
              (1, 33, 32, 77), (1, 1, 64, 1), (4, 50, 16, 200)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,t,kd,vd", WKV_SHAPES)
def test_wkv6_kernel(cuda, dtype, bh, t, kd, vd):
    args = _wkv6_args(cuda, dtype, bh, t, kd, vd, bh * t + kd + vd)
    ops.reset_launches()
    out = ops.wkv6(*args)
    assert dict(ops.LAUNCHES) == {("wkv6", "cuda"): 1}
    _model_close(out, wkv6.wkv6_plain(*args), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,heads,kd", [(6, 3, 64), (4, 4, 16), (2, 1, 32)])
def test_wkv6_per_head_u(cuda, dtype, bh, heads, kd):
    """u (H, K): head bh takes row bh % H, in the kernel as in plain."""
    args = _wkv6_args(cuda, dtype, bh, 70, kd, 40, 11 * bh + heads, heads)
    ops.reset_launches()
    out = ops.wkv6(*args)
    assert dict(ops.LAUNCHES) == {("wkv6", "cuda"): 1}
    _model_close(out, wkv6.wkv6_plain(*args), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kd", wkv6.HEAD_DIMS)
@pytest.mark.parametrize("bh,vd", [(3, 130), (320, 64)])
def test_wkv6_every_plan(cuda, dtype, kd, bh, vd):
    """Every plan the launcher takes for the shape (each block width of the
    dtype's tile), forced through plan=."""
    args = _wkv6_args(cuda, dtype, bh, 40, kd, vd, kd + bh + vd)
    ref = wkv6.wkv6_plain(*args)
    plans = wkv6.alternatives(bh, kd, vd, dtype)
    assert dict(plans[0]) == dict(wkv6.launch_plan(bh, kd, vd, dtype))
    for plan in plans:
        _model_close(wkv6.wkv6(*args, plan=plan), ref, dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vd", [64, 130])
def test_wkv6_unaligned_pointers(cuda, dtype, vd):
    """Inputs one element past a 16-byte boundary: the plan narrows its
    access width to what the pointers allow (4 bytes in float32, 2 in
    bfloat16) and the result is the same."""
    args = _wkv6_args(cuda, dtype, 2, 45, 64, vd, vd)
    shifted = []
    for a in args[:4]:
        buf = torch.empty(a.numel() + 1, dtype=dtype, device=cuda)
        t = buf[1:].view(a.shape)
        t.copy_(a)
        shifted.append(t)
    align = wkv6.alignment(*(t.data_ptr() for t in shifted))
    assert align == dtype.itemsize
    plan = wkv6.launch_plan(2, 64, vd, dtype, align)
    assert plan["bytes"] == dtype.itemsize
    out = wkv6.wkv6(*shifted, args[4])
    _model_close(out, wkv6.wkv6_plain(*args), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", flash_attention.HEAD_DIMS)
def test_flash_attention_kernel(cuda, dtype, d):
    torch.backends.cuda.matmul.allow_tf32 = False    # plain in full float32
    rng = np.random.default_rng(d)
    for causal, window, softcap, tq, tk in [
            (True, None, None, 200, 200), (False, None, None, 128, 512),
            (True, 64, 30.0, 300, 300), (False, 100, 50.0, 70, 333),
            # rows q >= tk + window - 1 have no valid key: the mean of v,
            # in query tiles with and without rows that have one
            (False, 64, None, 300, 100), (True, 32, None, 256, 96)]:
        q, k, v = _on(cuda, dtype, *(0.5 * rng.normal(size=(2, t, d))
                                     for t in (tq, tk, tk)))
        opts = dict(causal=causal, window=window, softcap=softcap)
        ops.reset_launches()
        out = ops.attention(q, k, v, **opts)
        assert dict(ops.LAUNCHES) == {("flash_attention", "cuda"): 1}
        _model_close(out, flash_attention.flash_attention_plain(q, k, v, **opts),
                     dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", flash_attention.HEAD_DIMS)
def test_flash_attention_tile_edges(cuda, dtype, d):
    """Tq and Tk one below, at and one above the query and key tile edges of
    the launch plan, with BH = 3 (a tensor map that read past a head's last
    row would mix heads); a causal diagonal inside a key tile (Tq != Tk);
    a window edge inside a key tile."""
    torch.backends.cuda.matmul.allow_tf32 = False
    plan = flash_attention.launch_plan(d, dtype)
    bq, bk = plan["block_q"], plan["block_k"]
    rng = np.random.default_rng(100 + d)
    cases = [(causal, None, tq, tk) for causal in (False, True)
             for tq, tk in [(bq - 1, bk - 1), (bq, bk), (bq + 1, bk + 1),
                            (bq + 1, 2 * bk - 1), (2 * bq - 1, 2 * bk + 1)]]
    cases += [(True, None, bq + bq // 2, 2 * bk + bk // 2),
              (True, bk // 2 + 3, 2 * bq + 5, 2 * bq + 5),
              (False, bk + 7, bq + 9, 3 * bk - 2)]
    for causal, window, tq, tk in cases:
        q, k, v = _on(cuda, dtype, *(0.5 * rng.normal(size=(3, t, d))
                                     for t in (tq, tk, tk)))
        opts = dict(causal=causal, window=window)
        out = flash_attention.flash_attention(q, k, v, **opts)
        _model_close(out, flash_attention.flash_attention_plain(q, k, v, **opts),
                     dtype)
    torch.cuda.synchronize()


def test_model_wrappers_reject_bad_inputs(cuda):
    r = torch.zeros((2, 64, 16), device=cuda)
    u = torch.zeros(16, device=cuda)
    with pytest.raises(TypeError):                   # float64 is not built
        wkv6.wkv6(r.double(), r.double(), r.double(), r.double(), u.double())
    with pytest.raises(TypeError):                   # mixed dtypes
        wkv6.wkv6(r, r, r.bfloat16(), r, u)
    r24 = torch.zeros((2, 64, 24), device=cuda)
    with pytest.raises(ValueError):                  # K = 24 is not built
        wkv6.wkv6(r24, r24, r24, r24, torch.zeros(24, device=cuda))
    with pytest.raises(ValueError):                  # not contiguous
        rt = torch.zeros((2, 16, 64), device=cuda).transpose(1, 2)
        wkv6.wkv6(rt, r, r, r, u)
    with pytest.raises(ValueError):                  # u is (K,) or (H, K)
        wkv6.wkv6(r, r, r, r, u[:8])
    with pytest.raises(ValueError):                  # H must divide BH
        wkv6.wkv6(r, r, r, r, torch.zeros((3, 16), device=cuda))
    with pytest.raises(ValueError):                  # (H, K) with K wrong
        wkv6.wkv6(r, r, r, r, torch.zeros((2, 8), device=cuda))
    with pytest.raises(ValueError):                  # u of three dimensions
        wkv6.wkv6(r, r, r, r, torch.zeros((1, 2, 16), device=cuda))
    plan = wkv6.launch_plan(2, 16, 16, torch.float32)
    ru = torch.empty(r.numel() + 1, device=cuda)[1:].view(r.shape)
    # bfloat16's 8 x 4 tile, consistent in every other entry, is not built
    # for float32
    other = dict(plan, rows=8, cols=4)
    assert other["threads"] == other["block_cols"] // 4 * (16 // 8)
    for bad, args in [(dict(plan, threads=plan["threads"] + 32), (r,) * 4),
                      (other, (r,) * 4),
                      (dict(plan, tile=16), (r,) * 4),
                      (dict(plan, stages=3), (r,) * 4),
                      (dict(plan, cols=3), (r,) * 4),
                      (dict(plan, rows=16), (r,) * 4),
                      (dict(plan, grid=plan["grid"] + 1), (r,) * 4),
                      (dict(plan, smem=plan["smem"] - 4), (r,) * 4),
                      (dict(plan, bytes=32), (r,) * 4),
                      (plan, (ru, r, r, r))]:     # 16-byte copies, unaligned r
        with pytest.raises(RuntimeError):
            wkv6.wkv6(*args, u, plan=bad)
    q = torch.zeros((2, 128, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q.double(), q.double(), q.double())
    for d in (96, 512):                              # not built / above 256
        qd = torch.zeros((2, 128, d), device=cuda)
        with pytest.raises(ValueError):
            flash_attention.flash_attention(qd, qd, qd)
    with pytest.raises(ValueError):                  # not contiguous
        qt = torch.zeros((2, 64, 128), device=cuda).transpose(1, 2)
        flash_attention.flash_attention(qt, q, q)
    with pytest.raises(ValueError):                  # k and v differ in length
        flash_attention.flash_attention(q, q, q[:, :64].contiguous())
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q, q, window=0)
    for dtype in (torch.float32, torch.bfloat16):    # 16-byte aligned data only
        flat = torch.zeros(2 * 128 * 64 + 1, device=cuda, dtype=dtype)
        odd = flat[1:].view(2, 128, 64)
        assert odd.is_contiguous() and odd.data_ptr() % 16
        with pytest.raises(ValueError):
            flash_attention.flash_attention(odd, q.to(dtype), q.to(dtype))
    with pytest.raises(ValueError):                  # cuda on CPU tensors
        ops.attention(q.cpu(), q.cpu(), q.cpu(), backend="cuda")


# --- the resilient campaign: runner, checkpoints and chaos on the card --------
# the step's kernel launches a step (K1/K2/K3/K4/K7), as the registry has them
CAMPAIGN_PER_STEP = {"solve_r": 2, "solve_w": 2, "block_thomas": 2,
                     "lateral_flux": 4, "tridiag": 4}


def _campaign_leg(case, tmp_path, name, plan=None, resume=False, n=6):
    cfg = RunnerConfig(checkpoint_dir=str(tmp_path / name),
                       checkpoint_every=2, max_retries=3, emit_metrics=False,
                       backoff_base_s=0.0)
    return sim_campaign.run_campaign(case, n, cfg,
                                     policy=sim_campaign.default_policy(),
                                     plan=plan, resume=resume)


def test_campaign_fault_free_legs_bitwise(cuda, tmp_path):
    """Two fault-free 6-step legs of the small campaign through the cuda
    backend end bitwise equal: the step is deterministic on the card."""
    case = sim_campaign.build_case(nx=4, ny=3, nl=4, device=cuda)
    ops.reset_launches()
    a, runner = _campaign_leg(case, tmp_path, "a")
    assert dict(ops.LAUNCHES) == {(op, "cuda"): 6 * n
                                  for op, n in CAMPAIGN_PER_STEP.items()}
    assert runner.stats["steps"] == 6 and a.ux.is_cuda
    b, _ = _campaign_leg(case, tmp_path, "b")
    assert bitwise_equal(a, b)


def test_campaign_restore_cuda_cpu_cuda_bitwise(cuda, tmp_path):
    """A checkpoint of the cuda leg restores onto the CPU bitwise, and that
    CPU state, checkpointed, restores onto the card bitwise."""
    case = sim_campaign.build_case(nx=4, ny=3, nl=4, device=cuda)
    st, runner = _campaign_leg(case, tmp_path, "leg")
    on_cpu = runner.ckpt.restore(case.state, devices="cpu")
    assert on_cpu.ux.device.type == "cpu"
    assert bitwise_equal(on_cpu, T.map_leaves(lambda x: x.cpu(), st))
    ck = Checkpointer(str(tmp_path / "host"))
    ck.save(6, on_cpu, blocking=True)
    back = ck.restore(on_cpu, devices=cuda)
    assert back.ux.is_cuda and bitwise_equal(back, st)


def test_campaign_poison_leg_bitwise(cuda, tmp_path):
    """NaN in T at step 5: the runner restores step 4 and re-runs; the leg
    ends bitwise equal to the fault-free one."""
    case = sim_campaign.build_case(nx=4, ny=3, nl=4, device=cuda)
    base, _ = _campaign_leg(case, tmp_path, "base")
    plan = chaos.FaultPlan([chaos.Fault("sim.state", "poison_nan", step=5,
                                        field="T")])
    out, runner = _campaign_leg(case, tmp_path, "nan", plan=plan)
    assert len(plan.log) == 1 and runner.stats["retries"] == 1
    assert bitwise_equal(out, base)


# --- the external burst as a CUDA graph ----------------------------------------
def _burst_fields(r):
    return (r.state.eta, r.state.qx, r.state.qy, *r[1:])


def test_burst_graph_bitwise_to_the_loop(cuda, monkeypatch):
    """The graphed burst, over 3 calls of each of a step's two keys (dt/2
    with m/2 sub-steps, dt with m) with new inputs each call, is
    torch.equal to the host's loop in every field; results returned earlier
    stay as they were; the counter reads 2 eager, 2 captures, 2 replays."""
    from repro_torch.core import dg2d, geometry, mesh2d
    from repro_torch.obs import trace
    monkeypatch.setattr(dg2d, "_GRAPHS", dg2d._BurstGraphs(dg2d.GRAPHS_KEPT))
    geom = geometry.geom2d_from_mesh(
        mesh2d.channel_mesh(50, 30, 3000.0, 900.0, seed=2),
        dtype=torch.float64, device=cuda)
    assert geom.nt == 3000 and float(geom.openb.sum()) > 0
    b = 10.0 + 10.0 * geom.node_x / 3000.0
    gen = torch.Generator(device=cuda).manual_seed(7)
    rnd = lambda s: s * torch.randn((3, geom.nt), generator=gen,
                                    dtype=torch.float64, device=cuda)
    ones = torch.ones((3, geom.nt), dtype=torch.float64, device=cuda)
    paths = ("burst.eager", "burst.capture", "burst.replay")
    before = [trace.counts().get(k, 0) for k in paths]
    m, kept = 8, []
    dt = m * dg2d.cfl_dt(geom, b)            # a stable sub-step
    for call in range(3):
        for dtau, m_sub in ((dt / 2, m // 2), (dt, m)):
            st0 = dg2d.State2D(rnd(0.01), rnd(0.5), rnd(0.5))
            f3x, f3y = rnd(1e-3), rnd(1e-3)
            forcing = dg2d.Forcing2D(
                eta_open=0.5 * torch.sin(torch.tensor(0.3 * call + dtau,
                                                      device=cuda)) * ones)
            out = dg2d.run_external(geom, b, st0, dtau, m_sub, forcing, f3x,
                                    f3y, h_min=0.05)
            ref = dg2d._run_eager(geom, b, st0, dtau, m_sub, forcing, f3x,
                                  f3y, 0.0, 0.0, 0.05)
            got = _burst_fields(out)
            assert all(bool(torch.isfinite(x).all()) for x in got)
            assert all(torch.equal(x, y) for x, y in zip(got, _burst_fields(ref)))
            kept.append((got, [x.clone() for x in got]))
    for got, copy in kept:
        assert all(torch.equal(x, y) for x, y in zip(got, copy))
    after = [trace.counts().get(k, 0) for k in paths]
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2]
    keys = list(dg2d._GRAPHS.entries)
    assert len(keys) == 2 and keys[0][0] == keys[1][0]
    e0, e1 = dg2d._GRAPHS.entries.values()
    assert e0.inputs is e1.inputs          # the two keys share their inputs


# ---------------------------------------------------------------------------
# the LM serving path: a reduced model's forward through K9 / K8 on the card
# ---------------------------------------------------------------------------
# logits of the cuda forward against the plain one, of max |logit|
LM_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
LM_KERNEL = {"olmo-1b": ("attention", "flash_attention"),
             "rwkv6-3b": ("wkv6", "wkv6")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(LM_KERNEL))
def test_lm_forward_cuda_matches_plain(cuda, name, dtype):
    """A reduced model's forward on `auto` (the kernel, once a layer; the
    registry's cuda dispatches equal) against `plain` on the card; a decode
    step launches neither kernel."""
    from repro_torch.configs import get_arch, reduce_arch
    from repro_torch.models.model import Model
    arch = reduce_arch(get_arch(name))
    model = Model(arch, dtype=dtype, device=cuda)
    params = model.init(0)
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, arch.vocab, (2, 64), generator=g, device=cuda)
    op, kernel = LM_KERNEL[name]
    metrics.reset()
    ops.reset_launches()
    with torch.inference_mode():
        logits, _ = model.forward(params, {"tokens": toks})
    torch.cuda.synchronize()
    assert dict(ops.LAUNCHES) == {(kernel, "cuda"): arch.n_layers}
    counters = metrics.default().snapshot()["counter"]
    assert counters[f"kernel_dispatch{{backend=cuda,op={op}}}"] == arch.n_layers
    plain = Model(arch, dtype=dtype, device=cuda, backend="plain")
    with torch.inference_mode():
        ref, _ = plain.forward(params, {"tokens": toks})
        ops.reset_launches()
        cache = model.init_cache(2, 4)
        model.decode_step(params, cache, toks[:, :1], 0)
    assert not any(k[1] == "cuda" for k in ops.LAUNCHES)
    scale = float(ref.float().abs().max())
    assert float((logits.float() - ref.float()).abs().max()) <= LM_TOL[dtype] * scale


def test_model_kernels_refuse_grad_on_cuda(cuda):
    """K8 and K9 no longer refuse inputs that require grad: on the cuda
    backend they go through their autograd Functions (the kernel forward,
    a plain torch backward) and give every input a gradient."""
    q = torch.randn(2, 64, 16, device=cuda, requires_grad=True)
    ops.reset_launches()
    ops.attention(q, q, q).sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    r = torch.rand(2, 8, 64, device=cuda, requires_grad=True)
    ops.wkv6(r, r, r, r, torch.zeros(64, device=cuda)).sum().backward()
    assert r.grad is not None and bool(torch.isfinite(r.grad).all())
    assert dict(ops.LAUNCHES) == {("flash_attention", "cuda"): 1,
                                  ("wkv6", "cuda"): 1}
    with torch.no_grad():
        assert ops.attention(q, q, q).shape == q.shape


# --- the training path: K9's row statistics, the Functions' gradients -------
# gradients with the kernel forward against autograd through the plain
# version, of each one's max |g|: float32 the kernels' summation orders;
# bfloat16 the plain version's roundings (q * scale, p) inside its graph
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
ATTN_GRAD_CASES = [(True, None, None, 256, 256), (True, 64, 30.0, 200, 200),
                   (False, None, None, 96, 300), (False, 32, None, 200, 100)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_attention_row_statistics(cuda, dtype, d):
    """m and l of K9 against the plain version's (float32, relative 1e-5 in
    float32; in bfloat16 the kernel rounds q * scale as the plain version
    does, and l sums float32 p, held to 1e-2), the rows with no valid key
    at m = -1e30, l = Tk; the output with statistics bitwise the output
    without."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7 + d)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for causal, window, softcap, tq, tk in ATTN_GRAD_CASES:
        q, k, v = _on(cuda, dtype, *(0.5 * rng.normal(size=(3, t, d))
                                     for t in (tq, tk, tk)))
        opts = dict(causal=causal, window=window, softcap=softcap)
        out, m, l = flash_attention.flash_attention(q, k, v, stats=True, **opts)
        assert torch.equal(out, flash_attention.flash_attention(q, k, v, **opts))
        _, pm, pl = flash_attention.flash_attention_plain(q, k, v, stats=True,
                                                          **opts)
        assert m.shape == l.shape == (3, tq) and m.dtype == torch.float32
        empty = pm == -1e30
        assert torch.equal(m == -1e30, empty)
        assert bool((l[empty] == tk).all())
        assert float((m - pm)[~empty].abs().max()) <= tol * float(pm[~empty].abs().max())
        assert float(((l - pl) / pl).abs().max()) <= tol
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_function_grads_against_plain_autograd(cuda, dtype):
    from repro_torch.models.attention import FlashAttention
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(11)
    for causal, window, softcap, tq, tk in ATTN_GRAD_CASES:
        q, k, v, do = _on(cuda, dtype, *(0.5 * rng.normal(size=(2, t, 128))
                                         for t in (tq, tk, tk, tq)))
        got = [t.clone().requires_grad_() for t in (q, k, v)]
        ops.reset_launches()
        FlashAttention.apply(*got, causal, window, softcap, "cuda").backward(do)
        assert dict(ops.LAUNCHES) == {("flash_attention", "cuda"): 1}
        want = [t.clone().requires_grad_() for t in (q, k, v)]
        flash_attention.flash_attention_plain(
            *want, causal=causal, window=window, softcap=softcap).backward(do)
        for a, b in zip(got, want):
            scale = float(b.grad.float().abs().max())
            err = float((a.grad.float() - b.grad.float()).abs().max())
            assert err <= GRAD_TOL[dtype] * scale, (causal, window, err, scale)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_function_grads_against_plain_autograd(cuda, dtype):
    """WKV6 on the card (K8 forward, the chunked form's gradient) against
    autograd through the plain recurrence, rwkv6-3b's head (K 64), u per
    head."""
    from repro_torch.models.rwkv import WKV6
    args = _wkv6_args(cuda, dtype, 4, 200, 64, 64, 12, heads=2)
    do = torch.randn(4, 200, 64, device=cuda, dtype=dtype)
    got = [t.clone().requires_grad_() for t in args]
    ops.reset_launches()
    WKV6.apply(*got, "cuda").backward(do)
    assert dict(ops.LAUNCHES) == {("wkv6", "cuda"): 1}
    want = [t.clone().requires_grad_() for t in args]
    wkv6.wkv6_plain(*want).backward(do)
    for name, a, b in zip("rkvwu", got, want):
        scale = float(b.grad.float().abs().max())
        err = float((a.grad.float() - b.grad.float()).abs().max())
        assert err <= GRAD_TOL[dtype] * scale, (name, err, scale)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the LM mesh path: ranks that share the card
# ---------------------------------------------------------------------------
def test_gloo_cuda_collectives(cuda):
    """Which of DTensor's four collectives plain gloo takes on CUDA tensors
    (2 ranks on cuda:0): each must run and give its value.  Then DTensor's
    own all-gather (Shard -> Replicate) on a CUDA mesh over the staged
    group, which stages it through the host (counted) and must be right.
    DTensor's all-gather on plain gloo killed its rank with a segmentation
    fault on the card (torch 2.11), the reason it is staged; that run is
    not repeated here."""
    import torch_mesh_ranks as R
    from repro_torch.distributed import spawn
    got = spawn.run(R.gloo_cuda_probe, 2, timeout_s=300)
    print("gloo on CUDA tensors:", got[0])
    for r in got:
        assert all(v == "ok" for v in r.values()), r
    staged = spawn.run(R.dtensor_all_gather_cuda, 2, timeout_s=300,
                       device="cuda")
    print("DTensor all-gather over the staged group:", staged[0])
    for r in staged:
        assert r["ok"] and r["counts"]["all_gather_into_tensor"] == 1, r


def test_mesh_step_on_the_card_matches_one_device(cuda):
    """One train step of a reduced olmo (float32, 4 heads) on a (1, 2) mesh
    of 2 ranks sharing the card, through K9, against the same step on one
    device: the loss within 1e-5, every parameter within 1e-5 absolute
    (AdamW eps 1e-3, lr 1e-2: the step is smooth in the gradient); each
    rank launches K9 on its own 2 heads, its state stays on the card, and
    the staged all-gathers are counted."""
    import torch_mesh_ranks as R
    from repro_torch.configs import get_arch, reduce_arch
    from repro_torch.distributed import spawn
    from repro_torch.launch import train as ttrain
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    arch = reduce_arch(get_arch("olmo-1b"))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, arch.vocab, (2, 33)).astype(np.int32)
    case = dict(arch=arch, shape=(1, 2), lr=1e-2, eps=1e-3,
                batch={"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    got = spawn.run(R.gpu_mesh_step, 2, args=(case,), timeout_s=600,
                    device="cuda")
    model = Model(arch, dtype=torch.float32, device=cuda)
    params = model.init(0)
    step = ttrain.make_train_step(model, adamw.AdamWConfig(lr=1e-2, eps=1e-3))
    batch = {k: torch.from_numpy(v.astype(np.int64)).to(cuda)
             for k, v in case["batch"].items()}
    (want, _), loss = step((params, adamw.init(params)), batch)
    print("mesh ranks:", [{k: r[k] for k in ("loss", "launches", "staged")}
                          for r in got], "one device loss", float(loss))
    for r in got:
        assert abs(r["loss"] - float(loss)) <= 1e-5 * abs(float(loss)), r["loss"]
        assert r["on_card"]
        assert r["launches"] == {"flash_attention/cuda": 1}, r["launches"]
        assert r["rows"] == [("attention", 2 * arch.n_heads // 2)], r["rows"]
    for a, b in zip(got[0]["params"], T.leaves(want)):
        assert np.abs(a - b.cpu().numpy()).max() <= 1e-5


@pytest.mark.parametrize("name", ["olmo-1b", "rwkv6-3b"])
def test_mesh_2x2_on_the_card_matches_one_device(cuda, name):
    """Two train steps of a reduced model (float32; rwkv6 with 4 heads of
    16) on a 2 x 2 ("data", "model") mesh of 4 ranks sharing the card,
    through K9 / K8, against the same steps on one device: each loss within
    1e-5, every leaf's m and v within 1e-4 of its max (the CPU mesh tests'
    MOMENT_TOL), every parameter within 1e-5 absolute (eps 1e-3, lr 1e-2:
    the step is smooth in the gradient); each rank's kernel calls on its
    own B / 2 rows of H / 2 heads.  The data x model mesh and K8's u
    gradient (a partial sum over the data axis) where float32 shows a
    fault: in bfloat16 at full size (`chip_smoke.py` phase 11) rwkv6-3b's
    first-step gradients on a sound mesh part from one device's by up to
    a third of a leaf's max."""
    import torch_mesh_ranks as R
    from repro_torch.configs import get_arch, reduce_arch
    from repro_torch.distributed import spawn
    from repro_torch.launch import train as ttrain
    from repro_torch.models.model import Model
    from repro_torch.models.rwkv import RwkvCfg
    from repro_torch.optim import adamw
    arch = reduce_arch(get_arch(name))
    if arch.rwkv is not None:
        arch = dataclasses.replace(arch, rwkv=RwkvCfg(head_dim=16))
    heads = arch.d_model // arch.rwkv.head_dim if arch.rwkv else arch.n_heads
    op = "wkv6" if arch.rwkv else "attention"
    B, steps = 4, 2
    rng = np.random.default_rng(0)
    toks = rng.integers(0, arch.vocab, (B, 33)).astype(np.int32)
    case = dict(arch=arch, shape=(2, 2), lr=1e-2, eps=1e-3, steps=steps,
                batch={"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    got = spawn.run(R.gpu_mesh_step, 4, args=(case,), timeout_s=600,
                    device="cuda")
    model = Model(arch, dtype=torch.float32, device=cuda)
    params = model.init(0)
    step = ttrain.make_train_step(model, adamw.AdamWConfig(lr=1e-2, eps=1e-3))
    batch = {k: torch.from_numpy(v.astype(np.int64)).to(cuda)
             for k, v in case["batch"].items()}
    state, losses = (params, adamw.init(params)), []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    print(f"{name} mesh ranks:", [{k: r[k] for k in ("losses", "launches",
                                                     "staged")} for r in got],
          "one device", losses)
    kernel = "wkv6" if arch.rwkv else "flash_attention"
    per_step = model.n_super * sum(sub.mixer in ("attn", "rwkv")
                                   for sub in model.program)
    for r in got:
        for a, b in zip(r["losses"], losses):
            assert abs(a - b) <= 1e-5 * abs(b), (r["losses"], losses)
        assert r["on_card"]
        assert r["launches"] == {f"{kernel}/cuda": steps * per_step}, r["launches"]
        # the tap sees ops.wkv6 twice a launch: the model's call and its
        # Function's own
        assert set(r["rows"]) == {(op, B // 2 * heads // 2)}, r["rows"]
    leaf_err = lambda a, b: float(np.abs(a - b).max()
                                  / max(np.abs(b).max(), 1e-30))
    for k, tree_ in (("m", state[1].m), ("v", state[1].v)):
        for a, b in zip(got[0][k], T.leaves(tree_)):
            assert leaf_err(a, b.cpu().numpy()) <= 1e-4, k
    for a, b in zip(got[0]["params"], T.leaves(state[0])):
        assert np.abs(a - b.cpu().numpy()).max() <= 1e-5



# ---------------------------------------------------------------------------
# the ocean dry run: the card's record against the CPU's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("period", [0, 2])
def test_dryrun_record_on_the_card_is_the_cpu_record(cuda, period):
    """`trace_ocean` of a small cell (`rect_mesh(16, 16)`, 4 layers) on a
    fake group of 8 ranks: on the card through the CUDA kernels, and on the
    CPU through their plain versions, the same bytes, flops and halo
    counts, every kernel launched on the card, and the same state after
    the counted step: every leaf finite, T and S within 1e-4 of
    max(|x|, 1), as chip_smoke.py's phase 4 holds cuda against plain in
    float32."""
    from repro_torch.launch import ocean_dryrun
    from repro_torch.launch.mesh import small_spec
    cell = ocean_dryrun.OceanCell("small", 16, 16, 16e3, 16e3, 4, 4, 30.0,
                                  20.0, halo_exchange_period=period)
    traced = {dev: ocean_dryrun.trace_ocean(cell, small_spec(2, 4), device=dev,
                                            return_state=True)
              for dev in ("cuda", "cpu")}
    recs = {dev: rec for dev, (rec, _) in traced.items()}
    card, cpu = (traced[dev][1] for dev in ("cuda", "cpu"))
    for (path, a), b in zip(T.flatten_with_path(card), T.leaves(cpu)):
        if not isinstance(a, torch.Tensor):
            assert a == b, T.keystr(path)
            continue
        a = a.cpu()
        assert bool(torch.isfinite(a).all()), T.keystr(path)
        if T.keystr(path) in (".T", ".S"):
            scale = max(float(a.abs().max()), 1.0)
            assert float((a - b).abs().max()) <= 1e-4 * scale, T.keystr(path)
    for f in ("bytes", "flops", "n_collectives", "coll_bytes"):
        assert recs["cuda"]["hlo"][f] == recs["cpu"]["hlo"][f], f
    assert recs["cuda"]["partition"] == recs["cpu"]["partition"]
    assert ({k: v["launches"] for k, v in recs["cuda"]["kernels"].items()}
            == {"solve_r": 2, "solve_w": 2, "block_thomas": 2,
                "lateral_flux": 4, "tridiag": 4})
    assert recs["cuda"]["memory"]["peak_per_device"] > 0


def test_lm_dryrun_record_on_the_card_is_the_cpu_record(cuda):
    """`lm_dryrun.trace_cell` of olmo-1b train_4k, full size, on a fake
    group of (2, 4): traced on fake CUDA tensors (K9 through its custom op,
    whose fake runs) and on fake CPU tensors, the same bytes, flops,
    collectives and arguments, and the same K9 calls."""
    from repro_torch.launch import lm_dryrun
    from repro_torch.launch.mesh import small_spec
    recs = {dev: lm_dryrun.trace_cell("olmo-1b", "train_4k", small_spec(2, 4),
                                      device=dev) for dev in ("cuda", "cpu")}
    for f in ("bytes", "flops", "n_collectives", "coll_bytes"):
        assert recs["cuda"]["hlo"][f] == recs["cpu"]["hlo"][f], f
    assert (recs["cuda"]["memory"]["argument_bytes"]
            == recs["cpu"]["memory"]["argument_bytes"])
    assert recs["cuda"]["kernels"] == recs["cpu"]["kernels"]
    assert recs["cuda"]["device"] == "cuda" and "card" in recs["cuda"]
