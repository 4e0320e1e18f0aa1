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
poisoned leg bitwise to the fault-free one).

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
