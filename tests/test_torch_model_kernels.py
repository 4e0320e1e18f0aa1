"""The port's model kernels (K8 wkv6, K9 flash attention) and their entry
points `ops.wkv6` / `ops.attention` against the JAX package, on the CPU.

The same numpy inputs, made from a seed with the JAX tests' recipes
(`tests/test_kernels.py`), go through the JAX Pallas kernel in interpret mode
and JAX `ref`, and through the port's plain version and `ref`.

Tolerances:
  * float32: 1e-5 of max(|JAX result|, 1); both sides sum in float32 in
    much the same order.
  * bfloat16: 2e-2 of the largest |JAX result| of each output row (one
    query or token of one head); bf16 rounds q * scale and p (attention),
    k v^T and u k v^T (wkv6) and the output, and the rounded values differ
    wherever a float32 sum of another order lands on the other side of a
    bf16 rounding boundary.  Attention rows over many keys are small, so a
    limit for the whole output would be loose for them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import wkv6 as jwkv6  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch.kernels import dispatch, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import wkv6  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(out, exp, dtype="float32"):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else \
        np.asarray(jnp.asarray(out, jnp.float32))
    exp = np.asarray(jnp.asarray(exp, jnp.float32))
    assert out.shape == exp.shape, (out.shape, exp.shape)
    err = np.abs(out - exp)
    if dtype == "bfloat16":
        limit = TOL[dtype] * np.abs(exp).max(axis=-1, keepdims=True)
    else:
        limit = TOL[dtype] * max(np.abs(exp).max(), 1.0)
    assert (err <= limit).all(), (err.max(), (err - limit).max())


def _both(arrs, dtype):
    """numpy float32 arrays -> (jax arrays, torch tensors) of ``dtype``."""
    return ([jnp.asarray(a).astype(JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def _wkv6_inputs(seed, bh, t, kd, vd=None):
    """The recipe of tests/test_kernels.py::test_wkv6_sweep: r, k, v, u
    normal * 0.5, the decay w = exp(-exp(0.5 N - 1)) in (0, 1)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)
    r, k, v = n(bh, t, kd), n(bh, t, kd), n(bh, t, vd or kd)
    w = np.exp(-np.exp(rng.normal(size=(bh, t, kd)) * 0.5 - 1.0)).astype(np.float32)
    return [r, k, v, w, n(kd)]


def _qkv(seed, bh, tq, tk, d, amp=0.3):
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.normal(size=s) * amp).astype(np.float32)
    return [n(bh, tq, d), n(bh, tk, d), n(bh, tk, d)]


# --- K8 wkv6 ----------------------------------------------------------------
@pytest.mark.parametrize("kd", [16, 64])
@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("bh", [1, 3])
def test_wkv6_vs_jax(bh, t, kd):
    (jr, jk, jv, jw, ju), targs = _both(_wkv6_inputs(bh * t + kd, bh, t, kd),
                                        "float32")
    pallas = jwkv6.wkv6(jr, jk, jv, jw, ju, t_block=128, interpret=True)
    jax_ref = jref.wkv6(jr, jk, jv, jw, ju)
    _close(wkv6.wkv6_plain(*targs), pallas)
    _close(ref.wkv6(*targs), jax_ref)
    _close(wkv6.wkv6_plain(*targs), jax_ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_value_dim_differs(dtype):
    """V != K, through the Pallas kernel (t_block 128 carries S across two
    blocks); the output keeps v's dtype."""
    jargs, targs = _both(_wkv6_inputs(5, 2, 256, 32, vd=48), dtype)
    pallas = jwkv6.wkv6(*jargs, t_block=128, interpret=True)
    out = wkv6.wkv6_plain(*targs)
    assert out.dtype == TDT[dtype] and out.shape == (2, 256, 48)
    _close(out, pallas, dtype)
    _close(ref.wkv6(*targs), jref.wkv6(*jargs), dtype)


def test_wkv6_ragged_t():
    """T = 200 is no multiple of the Pallas time block: against JAX ref."""
    jargs, targs = _both(_wkv6_inputs(7, 3, 200, 64), "float32")
    exp = jref.wkv6(*jargs)
    _close(wkv6.wkv6_plain(*targs), exp)
    _close(ref.wkv6(*targs), exp)


@pytest.mark.parametrize("bh,heads,kd,vd", [(6, 3, 64, 64), (4, 4, 16, 48),
                                             (2, 1, 32, 32)])
def test_wkv6_per_head_u_vs_jax(bh, heads, kd, vd):
    """u (H, K), head bh taking row bh % H: the port's plain version, ref
    and the kernel's partition against JAX `models/rwkv.py::_wkv_with_state`
    with S0 = 0, in float32."""
    arrs = _wkv6_inputs(bh + heads + kd, bh, 70, kd, vd)
    arrs[4] = (np.random.default_rng(heads).normal(size=(heads, kd)) * 0.5
               ).astype(np.float32)
    jargs, targs = _both(arrs, "float32")
    exp, _ = jrwkv._wkv_with_state(*jargs, jnp.zeros((bh, kd, vd), jnp.float32))
    _close(wkv6.wkv6_plain(*targs), exp)
    _close(ref.wkv6(*targs), exp)
    _close(ops.wkv6(*targs, backend="plain"), exp)
    plan = wkv6.launch_plan(bh, kd, vd, torch.float32)
    _close(wkv6.wkv6_partitioned(*targs, plan), exp)


def test_wkv6_rejects_bad_bonus_shapes():
    """u is (K,) or (H, K) with H dividing BH."""
    _, (r, k, v, w, u) = _both(_wkv6_inputs(2, 4, 16, 16), "float32")
    for bad in (u[:8], torch.zeros((3, 16)), torch.zeros((2, 8)),
                torch.zeros((1, 2, 16))):
        with pytest.raises(ValueError):
            wkv6.wkv6_plain(r, k, v, w, bad)


# --- K9 flash attention -----------------------------------------------------
ATTN_CASES = [
    # (causal, window, softcap, tq, tk)
    (True, None, None, 256, 256),
    (False, None, None, 256, 256),
    (True, 64, 30.0, 256, 256),
    (False, None, None, 128, 512),
    (True, None, None, 128, 512),
    # rows q >= tk + window - 1 have no valid key: the mean of v
    (False, 64, None, 512, 128),
    (True, 32, 30.0, 384, 128),
]


@pytest.mark.parametrize("d", [32, 80])
@pytest.mark.parametrize("causal,window,softcap,tq,tk", ATTN_CASES)
def test_attention_vs_jax(causal, window, softcap, tq, tk, d):
    (jq, jk, jv), (q, k, v) = _both(_qkv(tq + tk + d, 2, tq, tk, d), "float32")
    opts = dict(causal=causal, window=window, softcap=softcap)
    pallas = jfa.flash_attention(jq, jk, jv, interpret=True, **opts)
    _close(fa.flash_attention_plain(q, k, v, **opts), pallas)
    _close(ref.chunked_attention(q, k, v, **opts),
           jref.chunked_attention(jq, jk, jv, **opts))
    _close(ref.chunked_attention(q, k, v, chunk=128, q_block=128, **opts),
           jref.chunked_attention(jq, jk, jv, chunk=128, q_block=128, **opts))
    _close(ref.attention(q, k, v, **opts), jref.attention(jq, jk, jv, **opts))


@pytest.mark.parametrize("causal,window,softcap", [(True, None, None),
                                                   (False, None, None),
                                                   (True, 64, 30.0)])
def test_attention_ragged_t(causal, window, softcap):
    """T = 200 is no multiple of the Pallas block: against JAX dense ref."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(200, 2, 200, 200, 80), "float32")
    opts = dict(causal=causal, window=window, softcap=softcap)
    exp = jref.attention(jq, jk, jv, **opts)
    _close(fa.flash_attention_plain(q, k, v, **opts), exp)
    _close(ref.chunked_attention(q, k, v, **opts), exp)


@pytest.mark.parametrize("causal,window,softcap", [(True, None, None),
                                                   (True, 64, 30.0)])
def test_attention_bf16_vs_pallas(causal, window, softcap):
    (jq, jk, jv), (q, k, v) = _both(_qkv(3, 2, 256, 256, 64, amp=0.5),
                                    "bfloat16")
    opts = dict(causal=causal, window=window, softcap=softcap)
    pallas = jfa.flash_attention(jq, jk, jv, interpret=True, **opts)
    out = fa.flash_attention_plain(q, k, v, **opts)
    assert out.dtype == torch.bfloat16
    _close(out, pallas, "bfloat16")
    _close(ref.chunked_attention(q, k, v, **opts),
           jref.chunked_attention(jq, jk, jv, **opts), "bfloat16")


def test_attention_plain_rejects_bad_options():
    q = torch.zeros((1, 8, 16))
    with pytest.raises(ValueError):
        fa.flash_attention_plain(q, q, q, window=0)
    with pytest.raises(ValueError):
        fa.flash_attention_plain(q, q, q, softcap=0.0)
    with pytest.raises(ValueError):     # JAX's block sizes must divide T
        ref.chunked_attention(torch.zeros((1, 1500, 16)), q, q)


# --- ops dispatch -------------------------------------------------------------
def test_model_ops_dispatch_on_cpu():
    """`auto` (and None) is ref on a CPU tensor; plain is the kernel's plain
    version; cuda on a CPU tensor raises.  Each call counts one dispatch."""
    cpu = torch.device("cpu")
    assert dispatch.resolve_model("auto", cpu) is dispatch.Backend.REF
    assert dispatch.resolve_model(None, cpu) is dispatch.Backend.REF
    assert dispatch.resolve_model("plain", cpu) is dispatch.Backend.PLAIN
    with pytest.raises(ValueError):
        dispatch.resolve_model("cuda", cpu)
    _, targs = _both(_wkv6_inputs(1, 2, 64, 16), "float32")
    _, (q, k, v) = _both(_qkv(2, 2, 128, 128, 32), "float32")
    metrics.reset()
    ops.reset_launches()
    a = ops.wkv6(*targs)
    b = ops.wkv6(*targs, backend="plain")
    c = ops.attention(q, k, v, backend="auto")
    e = ops.attention(q, k, v, backend="plain")
    _close(a, ref.wkv6(*targs))
    _close(b, wkv6.wkv6_plain(*targs))
    _close(c, ref.chunked_attention(q, k, v))
    _close(e, fa.flash_attention_plain(q, k, v))
    assert dict(ops.LAUNCHES) == {("wkv6", "ref"): 1, ("wkv6", "plain"): 1,
                                  ("flash_attention", "ref"): 1,
                                  ("flash_attention", "plain"): 1}
    counters = metrics.default().snapshot()["counter"]
    assert counters["kernel_dispatch{backend=ref,op=attention}"] == 1
    assert counters["kernel_dispatch{backend=plain,op=wkv6}"] == 1
    with pytest.raises(ValueError):
        ops.wkv6(*targs, backend="cuda")
    with pytest.raises(ValueError):
        ops.attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError):     # a kernel wrapper takes only CUDA
        wkv6.wkv6(*targs)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)
