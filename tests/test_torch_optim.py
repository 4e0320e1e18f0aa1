"""The port's optimizer and gradient compression (`repro_torch.optim`)
against the JAX package's (`repro.optim`), on the CPU.

Inputs are numpy draws from a seed, handed to both.  Tolerances:
  * AdamW `update`, 3 steps, clipping active and inactive, float32 and
    bfloat16 parameters: with clipping inactive the moments m and v are
    bitwise JAX's (the same float32 operations in the same order) and
    the float32 parameters within 2 ulp (XLA's fused elementwise pass
    against torch's one operation at a time; the bias corrections' pow);
    with clipping active the scale depends on the global norm, whose
    sum runs in another order, so m, v and the parameters are held
    within 1e-6 relative; bfloat16 parameters within 1 bfloat16 ulp;
  * `inplace=True` against the functional update: bitwise;
  * `compressed_grad_psum` on 4 gloo ranks against JAX's under
    `shard_map` on 4 host devices, 20 steps with error feedback: the error
    states within 1e-6 of max |gf|, the error-fed gradient they are the
    residual of (XLA may compute gf - q scale as one fused multiply-add,
    torch rounds q scale first: ~1 ulp of gf), and the means within 1e-6
    of max |mean| (the next step's shared scale comes from those error
    states).  Where gf / scale lies at a rounding tie the ulp may send an
    element to the neighbouring int8 value: such elements are one quantum
    off (the scale in the error state, scale / 4 in the mean) and must be
    fewer than 0.1%;
  * with no process group, the identity mean: one rank's quantised
    gradient, as JAX's on one device: the mean bitwise, the error within
    1e-6 of max |g|.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.optim import adamw, compression  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"w": (6, 5), "b": (5,), "s": ()}


def _tree(rng, scale=1.0):
    return {k: np.asarray(scale * rng.standard_normal(s), np.float32)
            for k, s in SHAPES.items()}


def _ulp_diff(a, b):
    """Largest distance in units of the last place of float32 (or of
    bfloat16's, given bfloat16 values as float32)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64)).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", ["inactive", "active"])
def test_adamw_update_matches_jax(dtype, clip):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    cfg = dict(lr=1e-2, weight_decay=0.1, clip_norm=100.0 if clip == "inactive"
               else 0.5)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in p0.items()}
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(tdt)
          for k, v in jp.items()}
    jopt, topt = jadamw.init(jp), adamw.init(tp)
    for step in range(3):
        g = _tree(rng, scale=1.0 + step)
        jg = {k: jnp.asarray(v).astype(jdt) for k, v in g.items()}
        tg = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(tdt)
              for k, v in jg.items()}
        jp, jopt = jadamw.update(jg, jopt, jp, jadamw.AdamWConfig(**cfg))
        tp, topt = adamw.update(tg, topt, tp, adamw.AdamWConfig(**cfg))
        assert int(topt.step) == int(jopt.step) == step + 1
        for k in SHAPES:
            for got, want in ((topt.m[k], jopt.m[k]), (topt.v[k], jopt.v[k])):
                assert got.dtype == torch.float32
                if clip == "inactive":
                    assert np.array_equal(got.numpy(), np.asarray(want)), k
                else:
                    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                               rtol=1e-6, atol=1e-12)
            assert tp[k].dtype == tdt
            got = tp[k].float().numpy()
            want = np.asarray(jp[k].astype(jnp.float32))
            if dtype == "bfloat16":
                assert _ulp_diff(got, want) <= 1 << 16, k      # 1 bf16 ulp
            elif clip == "inactive":
                assert _ulp_diff(got, want) <= 2, k
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_adamw_inplace_is_bitwise_the_functional_update():
    """A leaf larger than one slice (`SLICE_ELEMS`) is updated in slices."""
    rng = np.random.default_rng(1)
    shapes = {"big": (3, 40, 7), "vec": (9,), "s": ()}
    mk = lambda: {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for k, s in shapes.items()}
    params, cfg = mk(), adamw.AdamWConfig(lr=1e-2, clip_norm=0.5)
    fp, fo = {k: v.clone() for k, v in params.items()}, adamw.init(params)
    ip, io = {k: v.clone() for k, v in params.items()}, adamw.init(params)
    old, adamw.SLICE_ELEMS = adamw.SLICE_ELEMS, 100
    try:
        for _ in range(3):
            g = mk()
            fp, fo = adamw.update(g, fo, fp, cfg)
            ip2, io2 = adamw.update(g, io, ip, cfg, inplace=True)
            assert ip2 is ip and io2.m is io.m
            io = io2
    finally:
        adamw.SLICE_ELEMS = old
    for a, b in zip(T.leaves((fp, fo)), T.leaves((ip, io))):
        assert torch.equal(a, b)


def test_adamw_reduces_quadratic():
    """The port's copy of `tests/test_substrate.py::test_adamw_reduces_quadratic`."""
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(1.5)}
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0)
    state = adamw.init(params)
    loss_fn = lambda p: torch.sum(p["w"] ** 2) + p["b"] ** 2
    l0 = float(loss_fn(params))
    for _ in range(100):
        grads = {k: 2 * v for k, v in params.items()}
        params, state = adamw.update(grads, state, params, cfg)
    assert float(loss_fn(params)) < 1e-2 * l0


def test_global_norm_matches_jax():
    g = _tree(np.random.default_rng(2), 3.0)
    want = float(jadamw.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
    got = float(adamw.global_norm({k: torch.from_numpy(v) for k, v in g.items()}))
    assert abs(got - want) <= 1e-6 * want


# ---------------------------------------------------------------------------
# int8 error-feedback gradient compression
# ---------------------------------------------------------------------------
JAX_SCRIPT = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.optim.compression import compressed_grad_psum
sys.path.insert(0, "tests")
from torch_dist_ranks import compress_grads, COMPRESS_RANKS, COMPRESS_STEPS, \
    COMPRESS_WIDTH

mesh = jax.make_mesh((COMPRESS_RANKS,), ("data",),
                     axis_types=(jax.sharding.AxisType.Auto,))
def f(g, e):
    m, e2 = compressed_grad_psum({"w": g}, {"w": e}, "data", COMPRESS_RANKS)
    return m["w"], e2["w"]
sh = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                           out_specs=(P("data"), P("data"))))
e = jnp.zeros((COMPRESS_RANKS, COMPRESS_WIDTH), jnp.float32)
means, errs = [], []
for step in range(COMPRESS_STEPS):
    m, e = sh(jnp.asarray(compress_grads(step)), e)
    means.append(np.asarray(m)); errs.append(np.asarray(e))
np.savez(sys.argv[1], means=np.stack(means), errs=np.stack(errs))
'''


def _held(got, want, tol, quantum):
    """|got - want| <= tol, but at rounding ties (the neighbouring int8
    value): one quantum off, fewer than 0.1% of the elements."""
    d = np.abs(got - want)
    off = d > tol
    assert off.mean() < 1e-3, off.mean()
    assert (np.abs(d[off] - quantum) <= tol).all()


def test_compressed_grad_psum_on_4_ranks_matches_jax(tmp_path):
    import torch_dist_ranks as R
    from repro_torch.distributed import spawn
    out = tmp_path / "jax.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(out)],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT), env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    ref = np.load(out)
    n, steps = R.COMPRESS_RANKS, R.COMPRESS_STEPS
    got = spawn.run(R.compress_steps, n, timeout_s=300)
    means = np.stack([g[0] for g in got], axis=1)     # (steps, ranks, width)
    errs = np.stack([g[1] for g in got], axis=1)
    assert (means == means[:, :1]).all()              # every rank's mean
    grads = np.stack([R.compress_grads(s) for s in range(steps)])
    for s in range(steps):
        fed = grads[s] + (errs[s - 1] if s else 0.0)
        scale = np.abs(fed).max() / 127.0
        _held(errs[s], ref["errs"][s], 1e-6 * np.abs(fed).max(), scale)
        _held(means[s], ref["means"][s], 1e-6 * np.abs(ref["means"][s]).max(),
              scale / n)
        # the mean stays within 2% of the float32 mean (JAX's own check)
        true = grads[s].mean(0)
        assert np.abs(means[s, 0] - true).max() < 0.02 * np.abs(true).max() + 1e-6


def test_compressed_grad_psum_without_a_group_is_one_rank():
    g = {"w": np.random.default_rng(3).standard_normal(300).astype(np.float32),
         "b": np.float32(0.25) * np.ones(4, np.float32)}
    e = {k: np.zeros_like(v) for k, v in g.items()}
    jm, je = jax.jit(jax.shard_map(
        lambda g_, e_: jcomp.compressed_grad_psum(g_, e_, "d", 1),
        mesh=jax.make_mesh((1,), ("d",), axis_types=(jax.sharding.AxisType.Auto,)),
        in_specs=(jax.sharding.PartitionSpec(), jax.sharding.PartitionSpec()),
        out_specs=(jax.sharding.PartitionSpec(), jax.sharding.PartitionSpec())))(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in e.items()})
    tm, te = compression.compressed_grad_psum(
        {k: torch.from_numpy(v) for k, v in g.items()},
        compression.init_error_state({k: torch.from_numpy(v) for k, v in g.items()}))
    for k in g:
        assert np.array_equal(tm[k].numpy(), np.asarray(jm[k]))
        assert (np.abs(te[k].numpy() - np.asarray(je[k])).max()
                <= 1e-6 * np.abs(g[k]).max())
    assert np.abs(tm["w"].numpy() - g["w"]).max() <= np.abs(g["w"]).max() / 254 * 1.001
