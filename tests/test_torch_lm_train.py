"""The port's LM training path against the JAX package's, on the CPU.

JAX's parameters are carried into the port by `convert.lm_params_from_numpy`
(`tests/torch_lm.py`); every other input is a numpy draw from a seed.
Tolerances (all float32):
  * `loss` and its gradient for all 10 architectures at `reduce_arch`, on
    ``ref`` and ``plain``, against `jax.value_and_grad(model.loss)`: each
    gradient leaf within 1e-4 of that leaf's max |g| (the loss within 1e-4
    relative), as the forward is held (other summation orders: JAX's
    chunked WKV and blocked attention against the port's forms);
  * `remat` (and `remat_groups`) against no remat: bitwise, the
    recomputation repeats the same arithmetic;
  * the attention backward (`FlashAttention` with `flash_attention_plain`
    forward) against `jax.vjp(flash_attention_xla)`: out, dq, dk and dv
    within 1e-5 of each one's max |x|, the row statistics m within 1e-5 of
    max |m| (the rows with no valid key exactly at -1e30) and l within 1e-4
    relative (the forward's 128-key blocks against JAX's whole-row block:
    l sums up to Tk exps, each moved by the scores' rounding);
  * `wkv_chunked` (out, S_T and their gradient) and the `WKV6` Function
    (`wkv6_plain` forward) against JAX's `wkv_chunked` and its `jax.vjp`:
    within 1e-5 of max |x| (2e-5 for the gradients, which sum over T).
    The one exception is the gradient of w at decays near 0 (w down to
    1e-6), which float32 does not determine to that: there both are held
    to the same form evaluated in float64, the port within 2e-3 of max |g|
    and no further than twice JAX's distance (both ~1e-3 at these inputs);
  * Mamba's gradient through the chunk-checkpointed scan: within 1e-4 of
    each leaf's max |g|;
  * two steps of `launch.train`'s train step against JAX's `train_step`:
    the losses within 1e-5 relative, the moments m and v within 1e-4 of
    each leaf's max, and every parameter within 0.05 lr a step of JAX's
    (AdamW normalises each element's step by its own gradient, so an
    element whose gradient is near the rounding floor takes a step of up
    to lr that the rounding decides: ~0.008 lr at these inputs);
  * a checkpoint of (params, opt) written by either framework's
    `TrainRunner` and resumed by the other's: the third step's state as
    above against three uninterrupted steps.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_lm as L  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.data.pipeline import TokenDataset  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import attention, mamba, rwkv  # noqa: E402
from repro_torch.models.model import Model, value_and_grad  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

B, SEQ = 2, 32
GRAD_TOL = 1e-4


def _leaf_errs(got, want):
    """{keystr: max |got - want| over max |want|} leaf for leaf, the paths
    in JAX's order."""
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = T.flatten_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [T.keystr(p) for p, _ in tl]
    return {T.keystr(p): L.rel_err(t, j) for (p, t), (_, j) in zip(tl, jl)}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(name):
    jm, jp, _, _ = L.pair(name, seed=0)
    b = L.batch(jm.arch, B, SEQ, seed=1)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(jp, L.to_jax(b))
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("backend", ["ref", "plain"])
@pytest.mark.parametrize("name", L.ARCHS)
def test_loss_and_grads_match_jax(name, backend):
    j_loss, j_grads = _jax_loss_and_grad(name)
    _, _, tm, tp = L.pair(name, seed=0, backend=backend)
    loss, grads = value_and_grad(tm.loss, tp, L.to_torch(L.batch(tm.arch, B, SEQ, seed=1)))
    assert abs(float(loss) - j_loss) <= GRAD_TOL * abs(j_loss), (float(loss), j_loss)
    errs = _leaf_errs(grads, j_grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    # the leaves of the caller's tree are left as they were
    assert not any(t.requires_grad for t in T.leaves(tp))


@pytest.mark.parametrize("name", L.ARCHS)
def test_remat_grads_are_bitwise_the_plain_grads(name):
    _, _, tm, tp = L.pair(name, seed=0, backend="plain")
    b = L.to_torch(L.batch(tm.arch, 1, 16, seed=1))
    rm = Model(dataclasses.replace(tm.arch, remat=True), dtype=torch.float32,
               device="cpu", backend="plain")
    loss0, g0 = value_and_grad(tm.loss, tp, b)
    loss1, g1 = value_and_grad(rm.loss, tp, b)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, c) for a, c in zip(T.leaves(g0), T.leaves(g1)))


def test_remat_groups_grads_are_bitwise():
    """Two super-blocks, checkpointed per sub-layer and as one group each."""
    arch = dataclasses.replace(L.reduce_arch(L.get_arch("olmo-1b")), n_layers=2)
    plain = Model(arch, dtype=torch.float32, device="cpu", backend="plain")
    grouped = Model(dataclasses.replace(arch, remat=True), dtype=torch.float32,
                    device="cpu", backend="plain")
    grouped.remat_groups = 2
    params = plain.init(3)
    b = L.to_torch(L.batch(arch, B, SEQ, seed=4))
    ops.reset_launches()
    loss0, g0 = value_and_grad(plain.loss, params, b)
    assert ops.LAUNCHES[("flash_attention", "plain")] == 2
    ops.reset_launches()
    loss1, g1 = value_and_grad(grouped.loss, params, b)
    # the forward and one recompute: torch's nested non-reentrant
    # checkpoints recompute a sub-layer once, inside the group's recompute
    assert ops.LAUNCHES[("flash_attention", "plain")] == 4
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, c) for a, c in zip(T.leaves(g0), T.leaves(g1)))


def test_value_and_grad_gives_zeros_for_an_unused_leaf():
    """hubert's forward reads frame embeddings, never `embed`: JAX's
    gradient of it is zeros, and so is the port's."""
    name = "hubert-xlarge"
    _, j_grads = _jax_loss_and_grad(name)
    _, _, tm, tp = L.pair(name, seed=0, backend="plain")
    _, grads = value_and_grad(tm.loss, tp, L.to_torch(L.batch(tm.arch, B, SEQ, seed=1)))
    assert not np.asarray(j_grads["embed"]).any()
    assert torch.equal(grads["embed"], torch.zeros_like(tp["embed"]))


# ---------------------------------------------------------------------------
# the attention backward against JAX's custom VJP
# ---------------------------------------------------------------------------
ATTN_CASES = {
    # name: (Tq, Tk, causal, window, softcap)
    "causal": (64, 64, True, None, None),
    "window": (64, 64, True, 16, None),
    "softcap": (64, 64, True, None, 30.0),
    "window_softcap": (64, 64, True, 16, 50.0),
    "non_causal": (64, 64, False, None, None),
    "tq_ne_tk": (32, 96, True, None, None),
    # rows q >= Tk + window - 1 = 39 have no valid key: m stays -1e30
    "no_valid_key": (64, 32, False, 8, None),
}


def _attn_inputs(Tq, Tk, seed, d=16, H=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, H, Tq, d)).astype(np.float32)
    k = rng.standard_normal((1, H, Tk, d)).astype(np.float32)
    v = rng.standard_normal((1, H, Tk, d)).astype(np.float32)
    do = rng.standard_normal((1, H, Tq, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_backward_matches_jax_vjp(case):
    Tq, Tk, causal, window, softcap = ATTN_CASES[case]
    q, k, v, do = _attn_inputs(Tq, Tk, seed=len(case))
    out_j, vjp = jax.vjp(lambda a, b_, c: jattn.flash_attention_xla(
        a, b_, c, causal, window, softcap), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    dq_j, dk_j, dv_j = vjp(jnp.asarray(do))
    _, m_j, l_j = jattn._forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal, window, softcap, 512, 1024)
    tq, tk, tv = (torch.from_numpy(x[0]).requires_grad_() for x in (q, k, v))
    out = attention.FlashAttention.apply(tq, tk, tv, causal, window, softcap,
                                         "plain")
    out.backward(torch.from_numpy(do[0]))
    for got, want in ((out, out_j), (tq.grad, dq_j), (tk.grad, dk_j),
                      (tv.grad, dv_j)):
        assert L.rel_err(got, np.asarray(want)[0]) <= 1e-5
    _, m, l = fa.flash_attention_plain(tq.detach(), tk.detach(), tv.detach(),
                                       causal, window, softcap, stats=True)
    m_j, l_j = np.asarray(m_j)[0, ..., 0], np.asarray(l_j)[0, ..., 0]
    empty = m_j == -1e30
    assert np.array_equal(m.numpy() == -1e30, empty)
    assert np.abs(m.numpy() - m_j)[~empty].max() <= 1e-5 * np.abs(m_j[~empty]).max()
    np.testing.assert_allclose(l.numpy(), l_j, rtol=1e-4)
    if case == "no_valid_key":
        assert (m[:, 39:] == -1e30).all() and (l[:, 39:] == Tk).all()
        assert (m[:, :39] > -1e29).all()


def test_attention_backward_takes_ragged_blocks():
    """Tq and Tk that no block divides: the blocks of 48 and 40 against one
    block each."""
    q, k, v, do = (torch.from_numpy(x[0]) for x in _attn_inputs(100, 90, seed=3))
    out, m, l = fa.flash_attention_plain(q, k, v, True, 24, 20.0, stats=True)
    whole = attention.flash_attention_bwd(q, k, v, out, m, l, do, True, 24, 20.0)
    cut = attention.flash_attention_bwd(q, k, v, out, m, l, do, True, 24, 20.0,
                                        q_block=48, k_block=40)
    for a, c in zip(whole, cut):
        assert L.rel_err(c, a) <= 1e-6


@pytest.mark.parametrize("backend", ["plain", "ref"])
def test_ops_attention_takes_grad(backend):
    """`ops.attention` differentiates on plain (the Function) and on ref
    (autograd through the reference), to the same gradient."""
    q, k, v, do = (torch.from_numpy(x[0]) for x in _attn_inputs(48, 48, seed=5))
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.attention(*ref, causal=True, window=None, softcap=30.0,
                  backend="ref").backward(do)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launches()
    ops.attention(*ts, causal=True, window=None, softcap=30.0,
                  backend=backend).backward(do)
    assert dict(ops.LAUNCHES) == {("flash_attention", backend): 1}
    for a, c in zip(ts, ref):
        assert L.rel_err(a.grad, c.grad) <= 1e-5


# ---------------------------------------------------------------------------
# the WKV: wkv_chunked and the WKV6 Function against JAX's wkv_chunked
# ---------------------------------------------------------------------------
def _wkv_inputs(decay, seed, BH=4, H=2, T=80, K=8):
    """Decays near 0 ("strong": w ~ 1e-6 .. 1e-2) or near 1 ("weak": 1 -
    w ~ 1e-4 .. 1e-2), or spread over (0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((BH, T, K)).astype(np.float32) for _ in range(3))
    lo, hi = {"strong": (1e-6, 1e-2), "weak": (1 - 1e-2, 1 - 1e-4),
              "spread": (0.05, 0.95)}[decay]
    w = rng.uniform(lo, hi, (BH, T, K)).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, K))).astype(np.float32)
    S0 = rng.standard_normal((BH, K, K)).astype(np.float32)
    dout = rng.standard_normal((BH, T, K)).astype(np.float32)
    dS = rng.standard_normal((BH, K, K)).astype(np.float32)
    return r, k, v, w, u, S0, dout, dS


def _wkv_f64_grads(xs, cot, chunk):
    """The gradient of `wkv_chunked`'s form in float64 (its chunk body on
    float64 tensors): the reference where float32 does not settle it."""
    ts = [torch.from_numpy(x).double().requires_grad_() for x in xs]
    r, k, v, w, uh, S = ts
    outs = []
    for c0 in range(0, r.shape[1], chunk):
        S, o = rwkv._wkv_chunk(S, *(z[:, c0:c0 + chunk] for z in (r, k, v, w)), uh)
        outs.append(o)
    outs = (torch.cat(outs, dim=1), S)[:len(cot)]
    return torch.autograd.grad(outs, ts[:len(xs)], [torch.from_numpy(c).double()
                                                    for c in cot],
                               allow_unused=True)


def _hold_wkv_grad(name, got, want, decay, f64):
    if decay == "strong" and name == "w":
        ref = f64.numpy()
        assert L.rel_err(got, ref) <= max(2e-3, 2 * L.rel_err(np.asarray(want), ref))
    else:
        assert L.rel_err(got, np.asarray(want)) <= 2e-5, name


@pytest.mark.parametrize("decay", ["strong", "weak", "spread"])
def test_wkv_chunked_matches_jax(decay):
    """out, S_T and the gradient of <out, dout> + <S_T, dS> for every input,
    from a non-zero S0, T = 80 (JAX: one chunk of 80; the port: 64 + 16 and
    one of 80)."""
    r, k, v, w, u, S0, dout, dS = _wkv_inputs(decay, seed=7)
    uh = np.repeat(u, r.shape[0] // u.shape[0], 0)
    xs = (r, k, v, w, uh, S0)
    (out_j, S_j), vjp = jax.vjp(
        lambda *a: jrwkv.wkv_chunked(*a, chunk=80), *map(jnp.asarray, xs))
    g_j = vjp((jnp.asarray(dout), jnp.asarray(dS)))
    for chunk in (64, 80):
        ts = [torch.from_numpy(x).requires_grad_() for x in xs]
        out, S = rwkv.wkv_chunked(*ts, chunk=chunk)
        assert L.rel_err(out, np.asarray(out_j)) <= 1e-5
        assert L.rel_err(S, np.asarray(S_j)) <= 1e-5
        g = torch.autograd.grad((out, S), ts, (torch.from_numpy(dout),
                                               torch.from_numpy(dS)))
        f64 = _wkv_f64_grads(xs, (dout, dS), chunk)
        for name, a, c, e in zip("r k v w u S0".split(), g, g_j, f64):
            _hold_wkv_grad(name, a, c, decay, e)


@pytest.mark.parametrize("decay", ["strong", "weak"])
def test_wkv_function_matches_jax_vjp(decay):
    """`ops.wkv6` with grad on plain: `wkv6_plain` forward, the chunked
    form's gradient backward, against JAX's `wkv_chunked` from S = 0 with
    u's rows broadcast over the batch as `time_mix` does (T = 64)."""
    r, k, v, w, u, _, dout, _ = _wkv_inputs(decay, seed=11, T=64)
    BH = r.shape[0]
    out_j, vjp = jax.vjp(
        lambda r_, k_, v_, w_, u_: jrwkv.wkv_chunked(
            r_, k_, v_, w_, jnp.broadcast_to(u_[None], (BH // u_.shape[0],)
                                             + u_.shape).reshape(BH, -1),
            jnp.zeros((BH, 8, 8), jnp.float32), chunk=64)[0],
        *map(jnp.asarray, (r, k, v, w, u)))
    g_j = vjp(jnp.asarray(dout))
    ts = [torch.from_numpy(x).requires_grad_() for x in (r, k, v, w, u)]
    ops.reset_launches()
    out = ops.wkv6(*ts, backend="plain")
    out.backward(torch.from_numpy(dout))
    assert dict(ops.LAUNCHES) == {("wkv6", "plain"): 1}
    assert L.rel_err(out, np.asarray(out_j)) <= 1e-5
    uh = np.repeat(u, BH // u.shape[0], 0)
    f64 = _wkv_f64_grads((r, k, v, w, uh, np.zeros((BH, 8, 8), np.float32)),
                         (dout,), 64)
    f64 = list(f64[:4]) + [f64[4].reshape(BH // u.shape[0], *u.shape).sum(0)]
    for name, t, c, e in zip("r k v w u".split(), ts, g_j, f64):
        _hold_wkv_grad(name, t.grad, c, decay, e)


def test_time_mix_grads_match_jax():
    """rwkv's time-mix with the WKV inside its Function (T 64: one chunk)."""
    cfg = rwkv.RwkvCfg(head_dim=8)
    D, T_ = 16, 64
    jp = jrwkv.rwkv_params(jax.random.PRNGKey(2), D, 32,
                           jrwkv.RwkvCfg(head_dim=8), jnp.float32)
    tp = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")
    x = np.random.default_rng(2).standard_normal((2, T_, D)).astype(np.float32)
    jfn = lambda p, x_: jnp.sum(jrwkv.time_mix(p, x_, jrwkv.RwkvCfg(head_dim=8))[0] ** 2)
    g_j = jax.grad(jfn, argnums=(0, 1))(jp, jnp.asarray(x))
    _, g = value_and_grad(
        lambda p, x_: torch.sum(rwkv.time_mix(p["p"], p["x"], cfg,
                                              backend="plain")[0] ** 2),
        {"p": tp, "x": torch.from_numpy(x)}, None)
    errs = _leaf_errs(g["p"], g_j[0])
    assert max(errs.values()) <= GRAD_TOL, errs
    assert L.rel_err(g["x"], np.asarray(g_j[1])) <= GRAD_TOL


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------
def test_mamba_grad_matches_jax():
    """Through the scan checkpointed per 32-step chunk (T 64: two chunks)."""
    cfg = mamba.MambaCfg()
    D, T_ = 16, 64
    jp = jmamba.mamba_params(jax.random.PRNGKey(5), D, jmamba.MambaCfg(),
                             jnp.float32)
    tp = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")
    x = np.random.default_rng(5).standard_normal((2, T_, D)).astype(np.float32)
    jfn = lambda p, x_: jnp.sum(jnp.sin(jmamba.mamba_apply(p, x_, jmamba.MambaCfg())))
    g_j = jax.grad(jfn, argnums=(0, 1))(jp, jnp.asarray(x))
    _, g = value_and_grad(
        lambda p, _: torch.sum(torch.sin(mamba.mamba_apply(p["p"], p["x"], cfg))),
        {"p": tp, "x": torch.from_numpy(x)}, None)
    errs = _leaf_errs(g["p"], g_j[0])
    assert max(errs.values()) <= GRAD_TOL, errs
    assert L.rel_err(g["x"], np.asarray(g_j[1])) <= GRAD_TOL
    # the chunks change no number of the forward
    with torch.no_grad():
        u, dt, Bm, Cm = (torch.from_numpy(np.random.default_rng(6).random(s).astype(np.float32))
                         for s in ((2, 70, 8), (2, 70, 8), (2, 70, 4), (2, 70, 4)))
        A, Dv = -torch.rand(8, 4), torch.rand(8)
        assert torch.equal(mamba._ssm_scan(u, dt, Bm, Cm, A, Dv),
                           mamba._ssm_scan(u, dt, Bm, Cm, A, Dv, chunk=70))


# ---------------------------------------------------------------------------
# the train step, the runner and the checkpoints, against JAX's
# ---------------------------------------------------------------------------
STEP_TOL = 1e-5       # the loss, relative
MOMENT_TOL = 1e-4     # m and v, of each leaf's max
LR = 1e-2
PARAM_TOL = 0.05 * LR  # each parameter element, a step


def _jax_train_step(jm, cfg):
    @jax.jit
    def train_step(state, batch):
        params, opt = state
        loss, grads = jax.value_and_grad(jm.loss)(params, batch)
        params, opt = jadamw.update(grads, opt, params, cfg)
        return (params, opt), loss
    return train_step


def _olmo_pair():
    jm, jp, tm, tp = L.pair("olmo-1b", seed=0, backend="plain")
    ds = TokenDataset(vocab=tm.arch.vocab, seq_len=32, global_batch=4, seed=0,
                      device="cpu")
    return jm, jp, tm, tp, ds


def _jbatch(ds, step):
    return {k: jnp.asarray(v.numpy()) for k, v in ds.batch_at(step).items()}


def _close_moments(got, want):
    errs = _leaf_errs(got, jax.tree_util.tree_map(np.asarray, want))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= MOMENT_TOL, (worst, errs[worst])


def _close_params(got, want, steps):
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
    worst = max(float(np.abs(t.detach().numpy() - j).max())
                for t, j in zip(T.leaves(got), jl))
    assert worst <= PARAM_TOL * steps, worst


def test_two_train_steps_match_jax():
    jm, jp, tm, tp, ds = _olmo_pair()
    jstep = _jax_train_step(jm, jadamw.AdamWConfig(lr=LR))
    tstep = ttrain.make_train_step(tm, adamw.AdamWConfig(lr=LR))
    jstate, tstate = (jp, jadamw.init(jp)), (tp, adamw.init(tp))
    for s in range(2):
        jstate, jloss = jstep(jstate, _jbatch(ds, s))
        tstate, loss = tstep(tstate, ds.batch_at(s))
        assert abs(float(loss) - float(jloss)) <= STEP_TOL * abs(float(jloss))
    _close_params(tstate[0], jstate[0], 2)
    _close_moments(tstate[1].m, jstate[1].m)
    _close_moments(tstate[1].v, jstate[1].v)
    assert int(tstate[1].step) == int(jstate[1].step) == 2


# AdamW at its default eps 1e-8 on the two architectures whose mesh cases
# missed JAX there (gemma2-9b, jamba; `tests/test_torch_lm_mesh.py` runs
# eps 1e-3).  Step 1 moves an element by lr g / (|g| + eps) (the bias
# corrections cancel), whose slope eps / (|g| + eps)^2 is 1 / eps at g = 0:
# the gradients' float32 rounding (within GRAD_TOL) moves only elements
# whose |g| is a few eps, and those by up to lr.  Read at these inputs:
# gemma2-9b's step 1 within 0.0032 lr of JAX's, jamba's within 0.208 lr
# (a miss of PARAM_TOL), its 11 elements off by more than NEAR_TOL at |g|
# (clipped) of at most 3.19 eps; the port's AdamW on JAX's gradients gives
# JAX's step to 4.8e-7; jamba's free-running step 2 misses MOMENT_TOL (m
# 5.3e-3, v 5.5e-3 of a leaf's max; gemma2-9b 1.7e-5, 2.4e-5), and its
# step 2 from JAX's step-1 state does not (1.2e-5, 2.0e-5): the misses are
# conditioning of the update, not a port fault.
NEAR_TOL = PARAM_TOL / 5    # a step-1 element "near" a miss
NEAR_EPS = 16               # the most |g| / eps such an element may have
ADAMW_TOL = 1e-5            # the port's update on JAX's gradients (4.8e-7)


@pytest.mark.parametrize("name", ["gemma2-9b", "jamba-1.5-large-398b"])
def test_adamw_default_eps_misses_are_conditioning(name):
    jm, jp, tm, tp = L.pair(name, seed=0, backend="plain")
    ds = TokenDataset(vocab=tm.arch.vocab, seq_len=32, global_batch=4, seed=0,
                      device="cpu")
    jcfg, tcfg = jadamw.AdamWConfig(lr=LR), adamw.AdamWConfig(lr=LR)
    assert tcfg.eps == jcfg.eps == 1e-8
    to_port = lambda t: convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, t), device="cpu")

    # step 1: the loss and the gradients
    jloss, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, _jbatch(ds, 0))
    loss, g = value_and_grad(tm.loss, tp, ds.batch_at(0))
    assert abs(float(loss) - float(jloss)) <= STEP_TOL * abs(float(jloss))
    errs = _leaf_errs(g, jax.tree_util.tree_map(np.asarray, jg))
    print(f"{name}: step 1's gradients within {max(errs.values()):.3e} of a "
          f"leaf's max")
    assert max(errs.values()) <= GRAD_TOL, errs

    # the port's AdamW on JAX's gradients is JAX's step
    jp1, jo1 = jax.jit(functools.partial(jadamw.update, cfg=jcfg))(
        jg, jadamw.init(jp), jp)
    xp1, xo1 = adamw.update(to_port(jg), adamw.init(tp), tp, tcfg)
    jl1 = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp1)]
    on_jax_grads = max(float(np.abs(x.numpy() - j).max())
                       for x, j in zip(T.leaves(xp1), jl1))
    print(f"{name}: the port's AdamW on JAX's gradients within "
          f"{on_jax_grads:.3e} of JAX's step")
    assert on_jax_grads <= ADAMW_TOL
    _close_moments(xo1.m, jo1.m)
    _close_moments(xo1.v, jo1.v)

    # the port's own step 1: where its parameters part from JAX's
    tp1, to1 = adamw.update(g, adamw.init(tp), tp, tcfg)
    scale = min(1.0, jcfg.clip_norm / (float(jadamw.global_norm(jg)) + 1e-12))
    near, worst = [], 0.0
    for x, j, gt, gj in zip(T.leaves(tp1), jl1, T.leaves(g),
                            jax.tree_util.tree_leaves(jg)):
        d = np.abs(x.numpy() - j)
        worst = max(worst, float(d.max()))
        gt, gj = gt.numpy() * scale, np.asarray(gj) * scale
        # each element within the update's slope times its gradient's
        # difference: eps / (min |g| + eps)^2 on one side of 0, 1 / eps
        # across it
        low = np.minimum(np.abs(gt), np.abs(gj))
        slope = np.where(gt * gj > 0, jcfg.eps / (low + jcfg.eps) ** 2,
                         1.0 / jcfg.eps)
        assert (d <= LR * slope * np.abs(gt - gj) + ADAMW_TOL).all()
        near.extend(np.abs(gj[d > NEAR_TOL]) / jcfg.eps)
    print(f"{name}: step 1's parameters at most {worst / LR:.4g} lr from "
          f"JAX's; {len(near)} elements off by more than {NEAR_TOL:g}, their "
          f"|g| / eps at most {max(near, default=0.0):.4g}")
    assert max(near, default=0.0) <= NEAR_EPS

    # step 2 from JAX's step-1 state holds the moments (the free-running
    # step 2, from the port's own step 1, is printed: it misses)
    jstep = _jax_train_step(jm, jcfg)
    tstep = ttrain.make_train_step(tm, tcfg)
    (jp2, jo2), _ = jstep((jp1, jo1), _jbatch(ds, 1))
    jo1_port = convert.adamw_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jo1), device="cpu")
    (_, from_jax), _ = tstep((to_port(jp1), jo1_port), ds.batch_at(1))
    (_, free), _ = tstep((tp1, to1), ds.batch_at(1))
    for what in ("m", "v"):
        want = jax.tree_util.tree_map(np.asarray, getattr(jo2, what))
        print(f"{name} step 2 {what}: free-running "
              f"{max(_leaf_errs(getattr(free, what), want).values()):.3e}, "
              f"from JAX's step 1 "
              f"{max(_leaf_errs(getattr(from_jax, what), want).values()):.3e}")
        _close_moments(getattr(from_jax, what), getattr(jo2, what))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_frameworks(writer, tmp_path):
    """One framework's TrainRunner runs 2 steps and checkpoints (params,
    opt); the other's resumes from it and runs the third."""
    from repro.runtime import fault_tolerance as jft
    from repro_torch.runtime import fault_tolerance as tft
    jm, jp, tm, tp, ds = _olmo_pair()
    jstep = _jax_train_step(jm, jadamw.AdamWConfig(lr=LR))
    tstep = ttrain.make_train_step(tm, adamw.AdamWConfig(lr=LR))
    jds = lambda: None
    jds.batch_at = lambda s: _jbatch(ds, s)

    def j_fn(state, batch):
        state, loss = jstep(state, batch)
        return state, {"loss": loss}

    def t_fn(state, batch):
        state, loss = tstep(state, batch)
        return state, {"loss": loss}

    d = str(tmp_path / "ckpt")
    rc = dict(checkpoint_dir=d, checkpoint_every=2, emit_metrics=False)
    jstart, tstart = (jp, jadamw.init(jp)), (tp, adamw.init(tp))
    # three uninterrupted steps, for reference
    ref = jft.TrainRunner(j_fn, jds, jft.RunnerConfig(
        checkpoint_dir=str(tmp_path / "ref"), checkpoint_every=10,
        emit_metrics=False)).run(jstart, n_steps=3)
    if writer == "jax":
        jft.TrainRunner(j_fn, jds, jft.RunnerConfig(**rc)).run(jstart, n_steps=2)
        runner = tft.TrainRunner(t_fn, ds, tft.RunnerConfig(**rc))
        params, opt = runner.run(tstart, n_steps=3, resume=True)
    else:
        tft.TrainRunner(t_fn, ds, tft.RunnerConfig(**rc)).run(tstart, n_steps=2)
        runner = jft.TrainRunner(j_fn, jds, jft.RunnerConfig(**rc))
        jparams, jopt = runner.run(jstart, n_steps=3, resume=True)
        params = convert.lm_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        opt = convert.adamw_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jopt), device="cpu")
    assert runner.stats["steps"] == 1          # resumed at 2, ran the third
    _close_params(params, ref[0], 3)
    _close_moments(opt.m, ref[1].m)
    _close_moments(opt.v, ref[1].v)
    assert int(opt.step) == 3


def test_adamw_state_round_trip():
    jm, jp, _, tp, _ = _olmo_pair()
    jopt = jadamw.init(jp)
    opt = convert.adamw_state_from_numpy(jax.tree_util.tree_map(np.asarray, jopt),
                                         device="cpu")
    assert T.keystr(T.flatten_with_path(opt)[-1][0]) == ".step"
    assert opt.step.dtype == torch.int32
    back = jadamw.AdamWState(*convert.adamw_state_to_numpy(opt))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, jopt)))


def test_lm_end_to_end_loss_decreases():
    """The port's copy of `tests/test_system.py::test_lm_end_to_end_loss_
    decreases`: 40 steps of a 2-layer olmo-family model (the port's own
    seeded parameters) lower the mean loss by more than 0.05."""
    arch = dataclasses.replace(L.get_arch("olmo-1b"), n_layers=2, d_model=128,
                               n_heads=4, n_kv=4, d_ff=512, vocab=512,
                               remat=False)
    model = Model(arch, dtype=torch.float32, device="cpu")
    params = model.init(0)
    step = ttrain.make_train_step(model, adamw.AdamWConfig(lr=2e-3,
                                                           weight_decay=0.0))
    ds = TokenDataset(vocab=512, seq_len=64, global_batch=8, seed=1, device="cpu")
    state, losses = (params, adamw.init(params)), []
    for s in range(40):
        state, loss = step(state, ds.batch_at(s))
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) - 0.05, losses[:3]


def test_launch_train_main(tmp_path):
    losses = ttrain.main(["--arch", "olmo-1b", "--reduced", "--steps", "4",
                          "--batch", "2", "--seq", "32", "--device", "cpu",
                          "--ckpt", str(tmp_path / "c"), "--ckpt-every", "2"])
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert (tmp_path / "c" / "step_000000004").is_dir()
    # --mesh is no longer refused: it runs on spawned ranks
    # (tests/test_torch_lm_mesh.py::test_launch_train_mesh_main)
    assert ttrain.parse_mesh("2x4") == (2, 4)


def test_train_lm_main(tmp_path):
    from repro_torch import train_lm
    losses = train_lm.main(["--steps", "12", "--batch", "2", "--seq", "32",
                            "--device", "cpu", "--ckpt_dir", str(tmp_path)])
    assert len(losses) == 12


def test_bfloat16_checkpoint_is_jax_file_and_restores(tmp_path):
    """A bfloat16 (params, opt) state: the port writes each bfloat16 leaf
    as JAX's checkpoint does (the same 2-byte elements, which numpy reads
    back as |V2 from both files), restores its own bitwise, and restores
    JAX's bitwise."""
    from repro.checkpoint.checkpoint import Checkpointer as JCheckpointer
    from repro_torch.checkpoint.checkpoint import Checkpointer
    jm = L.JModel(L.j_reduce_arch(L.j_get_arch("olmo-1b")), dtype=jnp.bfloat16)
    jp = jm.init(jax.random.PRNGKey(1))
    jstate = (jp, jadamw.init(jp))
    tp = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")
    tstate = (tp, adamw.init(tp))
    assert tp["embed"].dtype == torch.bfloat16
    JCheckpointer(str(tmp_path / "j")).save(1, jstate, blocking=True)
    ck = Checkpointer(str(tmp_path / "t"))
    ck.save(1, tstate, blocking=True)
    leaf = "step_000000001/0__embed.npy"
    a, b = np.load(tmp_path / "j" / leaf), np.load(tmp_path / "t" / leaf)
    assert a.dtype == b.dtype == np.dtype("V2")
    assert a.shape == b.shape and a.tobytes() == b.tobytes()
    assert ck.verify(1) == []
    for d in ("t", "j"):
        got = Checkpointer(str(tmp_path / d)).restore(tstate)
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(T.leaves(got), T.leaves(tstate))), d
