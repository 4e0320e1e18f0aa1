"""The LM rank program keeps JAX's layouts (`models/layers.py`, `rwkv.py`,
`mamba.py`, `moe.py`), on the CPU, on fake groups (`launch/lm_dryrun.py:
trace_cell`) at full width, depth cut, and on 4 gloo ranks:

  * the kernel cores keep the batch where the activations have it
    (`layers.core_placements`): rwkv6-3b `train_4k` on (2, 4), whose batch
    lies on ("data", "model"), redistributes nothing for its WKV calls;
  * the loss is vocab-parallel (`layers.token_nll`): three all-reduces of
    a row statistic, not the logits;
  * the embedding looks tokens up in the rank's vocab shard
    (`layers.embed_lookup`): no table is gathered whole;
  * the MLP runs Megatron's layout under `local_map` on every torch
    version (`layers.tp_einsum`): each rank multiplies by its hidden
    shard, on (2, 4) and on the production (16, 16) mesh (where the MLP's
    flops a rank are the closed form 3 x 2 B_local T D F / 16 plus its two
    pointwise ops), and the norms see the residual stream reduced
    (`layers.add_residual`);
  * mamba's selective scan runs each rank's own di channels;
  * the loss and the lookup on 4 gloo ranks with V split, values and
    gradients, against one device.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.distributed import spawn  # noqa: E402
from repro_torch.launch import lm_dryrun  # noqa: E402
from repro_torch.launch.mesh import (MeshSpec, init_fake_group,  # noqa: E402
                                     make_mesh, small_spec)
from repro_torch.models import layers, mamba, sharding  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402

SPEC = small_spec(2, 4)
OLMO = configs.get_arch("olmo-1b")
# the rank's rows of train_4k (B 256) over "data" on (2, 4) and (16, 16)
ROWS = {(2, 4): 128, (16, 16): 16}
# values and gradients on the 2 x 2 mesh against one device, of max |ref|
GLOO_TOL = 1e-6


def _cut(name: str, n_layers: int):
    """``name`` at full width with ``n_layers`` layers, registered under a
    name of its own."""
    a = configs.get_arch(name)
    return dataclasses.replace(a, n_layers=n_layers, name=f"{name}/{n_layers}")


def _trace(arch, shape: str, spec: MeshSpec, mlp_calls=None,
           norms=None) -> dict:
    """trace_cell of ``arch`` (registered for the call); with
    ``mlp_calls`` a list, each counted `layers.mlp` call's flops and the
    local weight operands (their last two dims) of its products are
    appended to it, and to ``norms`` the placements of each counted
    `layers.norm` call's input."""
    counters = []

    class Counter(lm_dryrun.RankCounter):
        def __init__(self):
            super().__init__()
            self.weights = None
            counters.append(self)

        def count(self, func, args, kwargs, out, w):
            if self.weights is not None and func.overloadpacket in (
                    torch.ops.aten.mm, torch.ops.aten.bmm):
                self.weights.add(tuple(args[1].shape[-2:]))
            super().count(func, args, kwargs, out, w)

    real_mlp = layers.mlp

    def mlp(p, x, act):
        if not counters:                 # the warm-up step
            return real_mlp(p, x, act)
        c = counters[0]
        f0, c.weights = c.stats.flops, set()
        out = real_mlp(p, x, act)
        mlp_calls.append((c.stats.flops - f0, c.weights))
        c.weights = None
        return out
    real_norm = layers.norm

    def norm(x, w, kind):
        if counters:
            norms.add(repr(tuple(x.placements)))
        return real_norm(x, w, kind)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(configs.ALL_ARCHS, arch.name, arch)
        if mlp_calls is not None:
            mp.setattr(lm_dryrun, "RankCounter", Counter)
            mp.setattr(layers, "mlp", mlp)
            mp.setattr(layers, "norm", norm)
        return lm_dryrun.trace_cell(arch.name, shape, spec, device="cpu")


@pytest.fixture(scope="module")
def olmo():
    """olmo-1b `train_4k` at 2 layers on (2, 4) and at 1 layer on (16,
    16): the records and each mesh's counted MLP calls."""
    out = {}
    for mesh, n_layers in (((2, 4), 2), ((16, 16), 1)):
        calls, norms = [], set()
        rec = _trace(_cut("olmo-1b", n_layers), "train_4k",
                     MeshSpec(mesh, ("data", "model")), mlp_calls=calls,
                     norms=norms)
        out[mesh] = dict(rec=rec, calls=calls, norms=norms)
    return out


# ---------------------------------------------------------------------------
# C.3: the kernel cores keep the batch's placements
# ---------------------------------------------------------------------------
CORE_CASES = {   # (mesh, the batch's spec entry, heads) -> core placements
    "batch_on_data_and_model": (((2, 4), ("data", "model")), ("data", "model"),
                                40, "(Shard(dim=0), Shard(dim=0))"),
    "heads_on_model": (((2, 4), ("data", "model")), "data", 40,
                       "(Shard(dim=0), Shard(dim=1))"),
    "heads_model_does_not_divide": (((2, 4), ("data", "model")), "data", 6,
                                    "(Shard(dim=0), Replicate())"),
    "two_pods_batch_off_pod": (((2, 2, 4), ("pod", "data", "model")),
                               ("data", "model"), 40,
                               "(Replicate(), Shard(dim=0), Shard(dim=0))"),
}


@pytest.mark.parametrize("case", list(CORE_CASES))
def test_core_placements_keep_the_batch(case):
    """`core_placements` of a (B, H, T, K) DTensor with no hook: the batch
    stays on every mesh dim that splits it (rwkv6-3b's train batch lies on
    ("data", "model"), and on two pods not on "pod"), the heads go over
    "model" only when "model" does not carry the batch and divides them."""
    (sizes, names), batch, heads, want = CORE_CASES[case]
    spec = MeshSpec(sizes, names)
    init_fake_group(spec.size)
    try:
        mesh = make_mesh(spec, "cpu")
        meta = torch.empty((256, heads, 4096, 64), device="meta")
        x = lm_dryrun.fake_dtensor(meta, sharding.P(batch), mesh,
                                   FakeTensorMode(allow_non_fake_inputs=True),
                                   torch.device("cpu"))
        assert repr(layers.core_placements(x, None)) == want
    finally:
        dist.destroy_process_group()


def test_wkv_core_moves_nothing():
    """rwkv6-3b `train_4k` on (2, 4) (2 layers, full width): its batch lies
    on ("data", "model"), and every K8 call runs on the rank's own 32 rows
    and all 40 heads with no redistribution: the record holds no
    all-to-all (2.28e10 B at this depth, 4.402e11 B at full depth, while
    the core put the batch on "data" and the heads on "model")."""
    rec = _trace(_cut("rwkv6-3b", 2), "train_4k", SPEC)
    assert "all-to-all" not in rec["hlo"]["coll_by_kind"], rec["hlo"]["coll_by_kind"]
    (call,) = rec["kernels"]["wkv6"]["shapes"]
    assert call["shapes"][0] == [32 * 40, 4096, 64]


# ---------------------------------------------------------------------------
# the vocab-parallel loss and embedding
# ---------------------------------------------------------------------------
def test_loss_is_vocab_parallel(olmo):
    """olmo-1b `train_4k` on (2, 4): the loss's collectives are three
    all-reduces of a row statistic (max, sum of exp, gold logit), each
    (B / 2) x 4095 float32, against the 1.0547e11 B whole-vocab gather of
    the logits before (under 1 %); the peak at this depth reads 107.68 GB
    (542.74 GB while the loss gathered the logits)."""
    rec = olmo[(2, 4)]["rec"]
    coll = rec["hlo"]["coll_by_source"]["layers.token_nll"]
    assert coll == 3 * 2 * ROWS[(2, 4)] * 4095 * 4
    assert coll < 0.01 * 1.0547e11
    assert rec["memory"]["peak_per_device"] < 548.2e9 / 4


def test_embedding_gathers_no_table(olmo):
    """olmo-1b `train_4k` on (2, 4): the lookup's only collective is the
    FSDP gather over "data" of the rank's vocab shard, V / 4 x D bf16 (the
    whole table, gathered before, is 4x that; 3.09e8 B with its two
    stages)."""
    coll = olmo[(2, 4)]["rec"]["hlo"]["coll_by_source"]["layers.embed_lookup"]
    table = OLMO.vocab * OLMO.d_model * 2
    assert coll == table // 4


@pytest.mark.parametrize("mesh", [(2, 4), (16, 16)], ids=["2x4", "16x16"])
def test_mlp_runs_on_its_hidden_shard(olmo, mesh):
    """olmo-1b `train_4k`: every counted MLP call (forward and the remat
    recomputes) multiplies by the rank's hidden shard, (D, F / "model")
    and (F / "model", D) local weights, and
    counts the closed form's flops: 3 x 2 B_local T D F / M for the three
    products and B_local T F / M for each of SiLU and the gate's product.
    On torch 2.13 DTensor's own strategy gathered the weights to multiply
    the `Partial` input, 16x these flops at (16, 16)."""
    calls = olmo[mesh]["calls"]
    M = mesh[1]
    B, T, D, F = ROWS[mesh], 4096, OLMO.d_model, OLMO.d_ff
    want = 3 * 2 * B * T * D * F // M + 2 * B * T * F // M
    assert calls and all(f == want for f, _ in calls), (calls[:3], want)
    assert all(w == {(D, F // M), (F // M, D)} for _, w in calls), calls[:3]


def test_norms_see_the_reduced_stream(olmo):
    """olmo-1b `train_4k` on (2, 4): every norm's input, the residual
    stream, is whole over "model" (`layers.add_residual` reduces each
    row-parallel sub-layer output into it once), so no norm reduces its
    float32 intermediates: DTensor kept the stream a partial sum after
    attention's output projection and all-reduced the norm's (x - mean) in
    float32 before the MLP all-reduced its input again."""
    assert olmo[(2, 4)]["norms"] == {"(Shard(dim=0), Replicate())"}


# ---------------------------------------------------------------------------
# mamba's channels over "model"
# ---------------------------------------------------------------------------
# the di dim of each SSM weight, which JAX's specs split over "model"
# (`src/repro/models/sharding.py:74-85`)
SSM_DI = dict(w_xdt=0, w_dt=1, dt_bias=0, w_B=0, w_C=0, A_log=0, D=0)


def _ssm_counted(u, weights):
    """Bytes, flops and collectives by kind of `mamba._ssm` and its
    gradient, counted as the dry run counts one rank."""
    c = lm_dryrun.RankCounter()
    with lm_dryrun._propagation_marked(c), c:
        y = mamba._ssm(u, *weights)
        y = y.to_local() if layers.is_dtensor(y) else y
        torch.autograd.grad(y.sum(), [u, *weights])
    return c.stats.bytes, c.stats.flops, dict(c.stats.coll_by_kind)


def test_mamba_scans_its_own_channels():
    """jamba's selective scan at full width (di 16,384, dt rank 512, N 16)
    on (2, 4), u at the model's placements (rows over "data", di over
    "model") and the weights at JAX's specs: the rank's bytes and flops,
    forward and backward, are those of its rows on one device divided by
    about the "model" size (read: 0.2504 and 0.2500; the products to dt's
    rank, B and C are whole (B, T, 544) tensors on every rank), and its
    only collectives are the all-reduces of those products, forward and
    backward."""
    D, Bg, T = 8192, 16, 64
    di = configs.get_arch("jamba-1.5-large-398b").mamba.d_inner(D)
    rank, N = D // 16, 16
    metas = {k: torch.empty(s, device="meta") for k, s in dict(
        u=(Bg, T, di), w_xdt=(di, rank), w_dt=(rank, di), dt_bias=(di,),
        w_B=(di, N), w_C=(di, N), A_log=(di, N), D=(di,)).items()}
    specs = {k: sharding.P(*(("model" if d == SSM_DI[k] else None)
                             for d in range(metas[k].dim())))
             for k in mamba._SSM_KEYS}
    specs["u"] = sharding.P("data", None, "model")
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    init_fake_group(SPEC.size)
    try:
        mesh = make_mesh(SPEC, "cpu")
        u, *ws = (lm_dryrun.fake_dtensor(metas[k], specs[k], mesh, fm,
                                         torch.device("cpu")).requires_grad_()
                  for k in ("u",) + mamba._SSM_KEYS)
        got = _ssm_counted(u, ws)
    finally:
        dist.destroy_process_group()
    with fm:
        whole = [torch.empty((Bg // 2, T, di), requires_grad=True)] + [
            torch.empty(metas[k].shape, requires_grad=True)
            for k in mamba._SSM_KEYS]
    one = _ssm_counted(whole[0], whole[1:])
    for g, o in zip(got[:2], one[:2]):
        assert 0.25 <= g / o <= 0.28, (got, one)
    rows = Bg // 2
    assert got[2] == {"all-reduce": 2 * 2 * 4 * rows * T * (rank + 2 * N)}


# ---------------------------------------------------------------------------
# on 4 gloo ranks, against one device
# ---------------------------------------------------------------------------
def test_vocab_parallel_loss_and_embedding_match_one_device():
    """`token_nll` on logits at JAX's `logits_sharding` (rows over "data",
    V over "model") and `embed_lookup` on a table at its spec (V over
    "model", D over "data"), on a 2 x 2 mesh of gloo ranks: values and
    gradients against one device; the lookup's output is a partial sum
    over "model"."""
    got = spawn.run(R.vocab_parallel, 4, timeout_s=300)
    for r in got:
        assert r["placements"] == "(Shard(dim=0), Partial(sum))", r
        for key, err in r["errs"].items():
            assert err <= GLOO_TOL, (key, r["errs"])
