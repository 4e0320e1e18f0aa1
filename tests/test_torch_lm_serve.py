"""The port's decode path and serving launcher against the JAX package, for
the 9 decoder architectures at `reduce_arch` size in float32 on the CPU.

Tolerances: logits within 1e-4 of max |logit| (float32, other summation
orders); the decode state after two steps within 1e-4 of each leaf's
largest value (a leaf that is still zero exactly).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_lm as L  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_arch, reduce_arch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

B, TMAX = 2, 16


@pytest.mark.parametrize("name", L.DECODERS)
def test_decode_steps_match_jax(name):
    """Two decode_steps from an empty cache: the logits of each, and the
    cache after both, leaf for leaf by JAX's paths."""
    jm, jp, tm, tp = L.pair(name, seed=0)
    toks = np.random.default_rng(4).integers(0, tm.arch.vocab, (2, B, 1))
    jcache = jm.init_cache(B, TMAX)
    cache = tm.init_cache(B, TMAX)
    step = jax.jit(jm.decode_step)
    for pos in range(2):
        j_logits, jcache = step(jp, jcache, jnp.asarray(toks[pos], jnp.int32),
                                jnp.int32(pos))
        logits, cache = tm.decode_step(tp, cache, torch.from_numpy(toks[pos]),
                                       pos)
        assert logits.shape == (B, tm.arch.vocab)
        assert L.rel_err(logits, j_logits) <= L.TOL, (name, pos)
    # the stacked cache crosses convert with JAX's paths and shapes
    flat_j = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, jcache))[0]
    flat_t = T.flatten_with_path(convert.lm_params_to_numpy(cache))
    assert [jax.tree_util.keystr(p) for p, _ in flat_j] == \
        [T.keystr(p) for p, _ in flat_t]
    for (p, a), (_, b) in zip(flat_j, flat_t):
        assert a.shape == b.shape and a.dtype == b.dtype, p
        scale = np.abs(a).max()
        assert np.abs(a - b).max() <= L.TOL * scale, (jax.tree_util.keystr(p),)


@pytest.mark.parametrize("name", L.DECODERS)
def test_decode_matches_prefill(name):
    """Token-by-token decode reproduces the full-sequence forward (KV
    caches, RoPE positions, mamba and rwkv states), as the JAX package's
    test of the same name holds JAX's."""
    arch = reduce_arch(get_arch(name))
    if arch.frontend == "vlm":
        pytest.skip("vlm decode parity needs patch prefill (covered by shapes)")
    model = Model(arch, dtype=torch.float32, device="cpu")
    params = model.init(0)
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, arch.vocab, (B, 8)))
    logits_full, _ = model.forward(params, {"tokens": toks})
    cache = model.init_cache(B, 8)
    for t in range(8):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        assert L.rel_err(logits, logits_full[:, t]) <= L.TOL, (name, t)


@pytest.mark.parametrize("name", ["olmo-1b", "rwkv6-3b"])
def test_serve_main_prints_ok(name, capsys):
    serve.main(["--arch", name, "--reduced", "--device", "cpu",
                "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"arch={name} batch=4"
    assert re.fullmatch(r"prefill 8 tok: \d+\.\d\ds; decode 4 tok: \d+\.\d\ds "
                        r"\(\d+\.\d tok/s\)", out[1]), out[1]
    assert out[2].startswith("sample token ids: [") and out[3] == "OK"


def test_generate_is_greedy_and_matches_prefill():
    """generate(): the last prompt step's logits equal the forward's at the
    last prompt position, and each generated id is the argmax that decode
    gives after the ones before it."""
    model = Model(reduce_arch(get_arch("olmo-1b")), dtype=torch.float32,
                  device="cpu")
    params = model.init(0)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 128, (3, 6)))
    res = serve.generate(model, params, toks, gen=4)
    assert res["ids"].shape == (3, 4) and len(res["step_s"]) == 4
    full, _ = model.forward(params, {"tokens": toks})
    assert L.rel_err(res["logits"], full[:, -1]) <= L.TOL
    seq = torch.cat([toks, res["ids"]], dim=1)
    full, _ = model.forward(params, {"tokens": seq})
    assert torch.equal(res["ids"], full[:, 5:9].argmax(dim=-1))


def test_serve_refuses_without_card_and_encoder_only():
    if torch.cuda.is_available():
        pytest.skip("a card is present: serve would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device", "cpu"])
