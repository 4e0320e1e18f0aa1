"""The port's `Model` against the JAX package's, for all 10 architectures at
`reduce_arch` size in float32 on the CPU.

JAX's parameters are carried into the port by `convert.lm_params_from_numpy`;
the batches are numpy draws from a seed.  Tolerances:
  * `forward` logits and `loss`: within 1e-4 of max |logit| (of |loss| for
    the loss); both sides compute in float32 in other summation orders
    (JAX's chunked WKV and blocked attention against the port's `ref` and
    `plain` forms);
  * the parameter round trip port -> numpy: bitwise;
  * `Model.init`'s tree, `init_abstract`, `input_specs` and `count_params`:
    equal paths, shapes and dtypes (counts equal), at reduced and full size.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_lm as L  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import applicable_shapes as j_applicable  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import count_params as j_count_params  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import ALL_ARCHS, SHAPES, applicable_shapes, get_arch  # noqa: E402
from repro_torch.configs import reduce_arch  # noqa: E402
from repro_torch.models.model import Model, block_program, count_params  # noqa: E402

B, SEQ = 2, 32
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jax_tree(tree):
    """[(keystr, shape, dtype name)] of a JAX tree, in JAX's leaf order."""
    return [(jax.tree_util.keystr(p), tuple(x.shape), jnp.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_tree(tree):
    return [(T.keystr(p), tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in T.flatten_with_path(tree)]


@pytest.mark.parametrize("backend", ["ref", "plain"])
@pytest.mark.parametrize("name", L.ARCHS)
def test_forward_and_loss_match_jax(name, backend):
    jm, jp, tm, tp = L.pair(name, seed=0, backend=backend)
    b = L.batch(tm.arch, B, SEQ, seed=1)
    fn = jax.jit(lambda p, x: (jm.forward(p, x)[0], jm.loss(p, x)))
    j_logits, j_loss = fn(jp, L.to_jax(b))
    logits, _ = tm.forward(tp, L.to_torch(b))
    loss = tm.loss(tp, L.to_torch(b))
    assert logits.dtype == torch.float32
    assert L.rel_err(logits, j_logits) <= L.TOL, name
    assert abs(float(loss) - float(j_loss)) <= L.TOL * abs(float(j_loss)), \
        (float(loss), float(j_loss))
    # prefill is the forward's last position
    last = tm.prefill(tp, L.to_torch(b))
    assert torch.equal(last, logits[:, -1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", L.ARCHS)
def test_init_tree_matches_jax(name, dtype):
    """Paths, shapes and dtypes of the seeded tree and of the abstract one."""
    arch = reduce_arch(get_arch(name))
    jm = JModel(L.j_reduce_arch(L.j_get_arch(name)), dtype=JDT[dtype])
    want = _jax_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    tm = Model(arch, dtype=TDT[dtype], device="cpu")
    params = tm.init(0)
    assert _port_tree(params) == want
    assert _port_tree(tm.init_abstract()) == want
    # the seed decides the draws
    again = tm.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(params),
                                                 T.leaves(again)))


@pytest.mark.parametrize("name", L.ARCHS)
def test_params_round_trip_bitwise(name):
    jm = JModel(L.j_reduce_arch(L.j_get_arch(name)), dtype=jnp.float32)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    back = convert.lm_params_to_numpy(
        convert.lm_params_from_numpy(jp, device="cpu"))
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_t = T.flatten_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in flat_j] == \
        [T.keystr(p) for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_bfloat16_leaves_cross_by_their_bits():
    """A bfloat16 JAX tree arrives as torch.bfloat16 with the same bits, and
    leaves float32 (exact) on the way back; ``dtype`` casts floating leaves."""
    jm = JModel(L.j_reduce_arch(L.j_get_arch("rwkv6-3b")), dtype=jnp.bfloat16)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tp = convert.lm_params_from_numpy(jp, device="cpu")
    wq = tp["blocks"]["sub0"]["rwkv"]["w_r"]
    assert wq.dtype == torch.bfloat16
    assert tp["blocks"]["sub0"]["rwkv"]["decay"].dtype == torch.float32
    j_wq = np.asarray(jp["blocks"]["sub0"]["rwkv"]["w_r"])
    assert np.array_equal(wq.view(torch.int16).numpy(), j_wq.view(np.int16))
    back = convert.lm_params_to_numpy(tp)
    assert np.array_equal(back["blocks"]["sub0"]["rwkv"]["w_r"],
                          j_wq.astype(np.float32))
    f32 = convert.lm_params_from_numpy(jp, device="cpu", dtype=torch.float32)
    assert all(x.dtype == torch.float32 for x in T.leaves(f32))


@pytest.mark.parametrize("name", L.ARCHS)
def test_full_size_counts_and_specs_match_jax(name):
    """Full-size configs: the program, count_params, the abstract tree and
    input_specs of every applicable shape, against JAX's (shapes only)."""
    from repro.models.model import block_program as j_block_program
    arch = get_arch(name)
    jarch = L.j_get_arch(name)
    assert [(s.mixer, s.ffn, s.window) for s in block_program(arch)] == \
        [(s.mixer, s.ffn, s.window) for s in j_block_program(jarch)]
    jm = JModel(jarch, dtype=jnp.bfloat16)
    tm = Model(arch, dtype=torch.bfloat16, device="cpu")
    assert count_params(tm) == j_count_params(jm)
    assert _port_tree(tm.init_abstract()) == _jax_tree(jm.init_abstract())
    assert applicable_shapes(arch) == j_applicable(jarch)
    for s in applicable_shapes(arch):
        assert SHAPES[s] == SHAPES[s].__class__(**vars(J_SHAPES[s]))
        specs = tm.input_specs(SHAPES[s])
        assert all(x.device.type == "meta" for x in T.leaves(specs))
        assert _port_tree(specs) == _jax_tree(jm.input_specs(J_SHAPES[s]))


def test_configs_equal_jax():
    """Every ArchConfig, full and reduced, field for field."""
    import dataclasses
    assert sorted(ALL_ARCHS) == L.ARCHS
    for name in L.ARCHS:
        for red in (False, True):
            a, j = get_arch(name), L.j_get_arch(name)
            if red:
                a, j = reduce_arch(a), L.j_reduce_arch(j)
            for f in dataclasses.fields(a):
                av, jv = getattr(a, f.name), getattr(j, f.name)
                if dataclasses.is_dataclass(av):
                    assert dataclasses.asdict(av) == dataclasses.asdict(jv)
                else:
                    assert av == jv, (name, f.name)
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
