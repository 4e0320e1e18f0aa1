"""Each layer of the port's LM stack against its JAX function, on the CPU,
from seeded numpy inputs, with JAX's parameters carried across.

Tolerances (float32 unless named): 1e-5 of max(|JAX result|, 1) for one
layer (float32 sums in other orders); bfloat16 norms and RoPE within one
bfloat16 ulp of each element (at most 2^-7 of its value), since both sides
round the same float32 value and differ only where it lands on a rounding
boundary.
The prefill WKV goes through `ops.wkv6` on ``plain`` and ``ref`` against
JAX's `wkv_chunked`; attention through `ops.attention` on both against
JAX's `flash_attention_xla`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers, mamba, moe, rwkv  # noqa: E402

TOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(out, ref, tol=TOL):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1.0), err


def _params(jparams):
    """JAX parameters (a dict) -> the port's, by `convert`."""
    return convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _bf16_ulp_close(out, ref):
    out = out.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert (np.abs(out - ref) <= 2.0 ** -7 * np.abs(ref)).all()


# --- norms and RoPE ----------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms(dtype):
    rng = _rng(0)
    x, w = _normal(rng, 2, 5, 64), _normal(rng, 64, scale=0.1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    pairs = [(layers.rms_norm(tx, tw), jl.rms_norm(jx, jw)),
             (layers.nonparam_layer_norm(tx), jl.nonparam_layer_norm(jx)),
             (layers.norm(tx, tw, "rms"), jl.norm(jx, jw, "rms")),
             (layers.norm(tx, tw, "nonparam"), jl.norm(jx, jw, "nonparam"))]
    for out, ref in pairs:
        assert out.dtype == tdt
        if dtype == "float32":
            _close(out, ref)
        else:
            _bf16_ulp_close(out, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype):
    pos = np.arange(3, 40)
    cos, sin = layers.rope_freqs(16, 1e4, torch.from_numpy(pos))
    jcos, jsin = jl.rope_freqs(16, 1e4, jnp.asarray(pos))
    assert cos.dtype == torch.float32
    _close(cos, jcos)
    _close(sin, jsin)
    x = _normal(_rng(1), 2, len(pos), 3, 16)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    out = layers.apply_rope(torch.from_numpy(x).to(tdt), cos, sin)
    ref = jl.apply_rope(jnp.asarray(x, jdt), jcos, jsin)
    assert out.dtype == tdt
    if dtype == "float32":
        _close(out, ref)
    else:
        _bf16_ulp_close(out, ref)


# --- attention ---------------------------------------------------------------------
ATTN_CASES = {
    "causal": dict(n_heads=4, n_kv=4),
    "gqa": dict(n_heads=4, n_kv=2),
    "window": dict(n_heads=4, n_kv=2, window=8),
    "softcap": dict(n_heads=4, n_kv=4, softcap=5.0),
    "window+softcap": dict(n_heads=4, n_kv=1, window=5, softcap=3.0),
    "not causal": dict(n_heads=4, n_kv=4, causal=False),
}


def _attn(case):
    kw = ATTN_CASES[case]
    jcfg = jl.AttnCfg(head_dim=16, rope_theta=1e4, **kw)
    tcfg = layers.AttnCfg(head_dim=16, rope_theta=1e4, **kw)
    jp = jl.attn_params(jax.random.PRNGKey(0), 64, jcfg, jnp.float32)
    return jcfg, tcfg, jp, _params(jp)


@pytest.mark.parametrize("backend", ["ref", "plain"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention(case, backend):
    jcfg, tcfg, jp, tp = _attn(case)
    x = _normal(_rng(2), 2, 32, 64)
    ref = jl.attention(jp, jnp.asarray(x), jcfg, jnp.arange(32))
    ops.reset_launches()
    out = layers.attention(tp, torch.from_numpy(x), tcfg, torch.arange(32),
                           backend=backend)
    assert dict(ops.LAUNCHES) == {("flash_attention", backend): 1}
    _close(out, ref)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_decode_attention(case):
    """Three tokens into a KV cache of 12 slots (the first holding earlier
    values): the output and the cache against JAX's."""
    jcfg, tcfg, jp, tp = _attn(case)
    rng = _rng(3)
    k0 = _normal(rng, 2, 12, jcfg.n_kv, 16)
    v0 = _normal(rng, 2, 12, jcfg.n_kv, 16)
    jc = {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}
    tc = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    for pos in (4, 5, 11):
        x = _normal(rng, 2, 1, 64)
        ref, jc = jl.decode_attention(jp, jnp.asarray(x), jcfg, jc,
                                      jnp.int32(pos))
        out, tc = layers.decode_attention(tp, torch.from_numpy(x), tcfg, tc, pos)
        _close(out, ref)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])


def test_attn_cfg_refuses_head_padding():
    """The port once refused `pad_heads_to`; it now pads as JAX does: 3
    heads padded to 4 against JAX's padded attention, and the padding
    changes no number beyond float32 sums."""
    kw = dict(n_heads=3, n_kv=1, head_dim=16, rope_theta=1e4)
    jcfg = jl.AttnCfg(pad_heads_to=4, **kw)
    jp = jl.attn_params(jax.random.PRNGKey(0), 48, jcfg, jnp.float32)
    x = _normal(_rng(2), 2, 32, 48)
    ref = jl.attention(jp, jnp.asarray(x), jcfg, jnp.arange(32))
    outs = [layers.attention(_params(jp), torch.from_numpy(x),
                             layers.AttnCfg(pad_heads_to=pad, **kw),
                             torch.arange(32), backend="plain")
            for pad in (4, None)]
    _close(outs[0], ref)
    _close(outs[0], outs[1].detach().numpy())


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(act):
    jp = jl.mlp_params(jax.random.PRNGKey(1), 64, 96, act, jnp.float32)
    x = _normal(_rng(4), 2, 7, 64)
    _close(layers.mlp(_params(jp), torch.from_numpy(x), act),
           jl.mlp(jp, jnp.asarray(x), act))


# --- RWKV6 -------------------------------------------------------------------------
D_RWKV, K_RWKV = 64, 16          # 4 heads of 16: head bh takes u's row bh % 4


def _rwkv(seed=0):
    jcfg, tcfg = jrwkv.RwkvCfg(head_dim=K_RWKV), rwkv.RwkvCfg(head_dim=K_RWKV)
    jp = jrwkv.rwkv_params(jax.random.PRNGKey(seed), D_RWKV, 96, jcfg,
                           jnp.float32)
    # ln_x starts at zero: give it values so its scale is held too
    jp["ln_x"] = jnp.asarray(_normal(_rng(seed + 9), D_RWKV, scale=0.3))
    return jcfg, tcfg, jp, _params(jp)


@pytest.mark.parametrize("backend", ["ref", "plain"])
def test_time_mix_prefill(backend):
    """B = 2 and 4 heads: K8's bh % H row of u against JAX's (B, H) -> B*H
    flattening, through ops.wkv6 against JAX's wkv_chunked."""
    jcfg, tcfg, jp, tp = _rwkv()
    x = _normal(_rng(5), 2, 32, D_RWKV)
    ref, (jshift, jwkv) = jrwkv.time_mix(jp, jnp.asarray(x), jcfg)
    ops.reset_launches()
    out, (shift, wkv) = rwkv.time_mix(tp, torch.from_numpy(x), tcfg,
                                      backend=backend)
    assert dict(ops.LAUNCHES) == {("wkv6", backend): 1}
    assert wkv is None and jwkv is None
    _close(out, ref)
    _close(shift, jshift)


def test_time_mix_prefill_pins_bonus_rows():
    """The same with each head's bonus row permuted: the output changes, so
    the test above sees which row each head takes."""
    jcfg, tcfg, jp, tp = _rwkv()
    x = torch.from_numpy(_normal(_rng(5), 2, 32, D_RWKV))
    out, _ = rwkv.time_mix(tp, x, tcfg, backend="plain")
    tp2 = dict(tp, bonus=tp["bonus"].reshape(4, K_RWKV).roll(1, 0).reshape(-1))
    out2, _ = rwkv.time_mix(tp2, x, tcfg, backend="plain")
    assert float((out - out2).abs().max()) > 1e-3


def test_time_mix_decode_and_wkv_with_state():
    """Decode steps from a carried state (shift, WKV) against JAX's, then
    _wkv_with_state alone over 9 tokens."""
    jcfg, tcfg, jp, tp = _rwkv(1)
    rng = _rng(6)
    Bn, H = 2, D_RWKV // K_RWKV
    shift = _normal(rng, Bn, 1, D_RWKV)
    S = _normal(rng, Bn * H, K_RWKV, K_RWKV, scale=0.3)
    jstate, tstate = (jnp.asarray(shift), jnp.asarray(S)), \
        (torch.from_numpy(shift), torch.from_numpy(S))
    for _ in range(3):
        x = _normal(rng, Bn, 1, D_RWKV)
        ref, jstate = jrwkv.time_mix(jp, jnp.asarray(x), jcfg, *jstate)
        out, tstate = rwkv.time_mix(tp, torch.from_numpy(x), tcfg, *tstate)
        _close(out, ref)
        _close(tstate[0], jstate[0])
        _close(tstate[1], jstate[1])
    r, k, v = (_normal(rng, 8, 9, K_RWKV, scale=0.5) for _ in range(3))
    w = np.exp(-np.exp(_normal(rng, 8, 9, K_RWKV, scale=0.5) - 1.0))
    u = _normal(rng, 4, K_RWKV, scale=0.5)
    S0 = _normal(rng, 8, K_RWKV, K_RWKV)
    jo, jS = jrwkv._wkv_with_state(*(jnp.asarray(a) for a in (r, k, v, w, u, S0)))
    to, tS = rwkv._wkv_with_state(*(torch.from_numpy(a) for a in (r, k, v, w, u, S0)))
    _close(to, jo)
    _close(tS, jS)


def test_channel_mix_and_state():
    jcfg, tcfg, jp, tp = _rwkv(2)
    rng = _rng(7)
    x, last = _normal(rng, 2, 6, D_RWKV), _normal(rng, 2, 1, D_RWKV)
    for s in (None, last):
        ref, jsh = jrwkv.channel_mix(jp, jnp.asarray(x),
                                     None if s is None else jnp.asarray(s))
        out, sh = rwkv.channel_mix(tp, torch.from_numpy(x),
                                   None if s is None else torch.from_numpy(s))
        _close(out, ref)
        _close(sh, jsh)
    st = rwkv.init_rwkv_state(3, D_RWKV, tcfg, torch.bfloat16)
    jst = jrwkv.init_rwkv_state(3, D_RWKV, jcfg, jnp.bfloat16)
    for key in jst:
        assert tuple(st[key].shape) == jst[key].shape
    assert st["wkv"].dtype == torch.float32 and st["tm_shift"].dtype == torch.bfloat16


# --- Mamba -------------------------------------------------------------------------
def _mamba():
    jcfg, tcfg = jmamba.MambaCfg(), mamba.MambaCfg()
    jp = jmamba.mamba_params(jax.random.PRNGKey(3), 64, jcfg, jnp.float32)
    jp["conv_b"] = jnp.asarray(_normal(_rng(11), 128, scale=0.1))
    return jcfg, tcfg, jp, _params(jp)


@pytest.mark.parametrize("T", [8, 32, 64])
def test_mamba_apply(T):
    jcfg, tcfg, jp, tp = _mamba()
    x = _normal(_rng(8), 2, T, 64)
    _close(mamba.mamba_apply(tp, torch.from_numpy(x), tcfg),
           jmamba.mamba_apply(jp, jnp.asarray(x), jcfg))


def test_mamba_decode():
    """Decode from a carried (conv, ssm) state, step after step, and the
    port's decode through a prompt against its own prefill."""
    jcfg, tcfg, jp, tp = _mamba()
    rng = _rng(9)
    conv, h = _normal(rng, 2, 3, 128), _normal(rng, 2, 128, 16, scale=0.2)
    jst, tst = (jnp.asarray(conv), jnp.asarray(h)), \
        (torch.from_numpy(conv), torch.from_numpy(h))
    for _ in range(3):
        x = _normal(rng, 2, 1, 64)
        ref, jst = jmamba.mamba_decode(jp, jnp.asarray(x), jst, jcfg)
        out, tst = mamba.mamba_decode(tp, torch.from_numpy(x), tst, tcfg)
        _close(out, ref)
        _close(tst[0], jst[0])
        _close(tst[1], jst[1])
    x = torch.from_numpy(_normal(rng, 2, 5, 64))
    full = mamba.mamba_apply(tp, x, tcfg)
    st = mamba.init_mamba_state(2, 64, tcfg, torch.float32)
    for t in range(5):
        out, st = mamba.mamba_decode(tp, x[:, t:t + 1], st, tcfg)
        _close(out[:, 0], full[:, t].numpy())


# --- MoE ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_apply_and_aux(n_shared):
    jcfg = jmoe.MoeCfg(n_experts=6, top_k=2, d_ff=32, n_shared=n_shared)
    tcfg = moe.MoeCfg(n_experts=6, top_k=2, d_ff=32, n_shared=n_shared)
    jp = jmoe.moe_params(jax.random.PRNGKey(4), 64, jcfg, "swiglu", jnp.float32)
    x = _normal(_rng(10), 2, 9, 64)
    ref, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    out, aux = moe.moe_apply(_params(jp), torch.from_numpy(x), tcfg)
    _close(out, ref)
    assert abs(float(aux) - float(jaux)) <= TOL * abs(float(jaux))


def test_top_k_breaks_ties_as_jax():
    """Rows full of ties: the k largest and their indices equal
    jax.lax.top_k's, which prefers the lower index."""
    x = np.array([[0.5, 0.5, 0.5, 0.5], [0.1, 0.7, 0.7, 0.1],
                  [0.3, 0.2, 0.3, 0.2], [0.0, 0.0, 1.0, 0.0]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = moe.top_k(torch.from_numpy(x), k)
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        assert np.array_equal(tv.numpy(), np.asarray(jv))
