"""The port's LM dry run (`repro_torch.launch.lm_dryrun.trace_cell`,
`launch/dryrun.py: run_lm_cells`) against the JAX package's, on the CPU.

  * JAX's machinery test (`tests/test_system.py::
    test_dryrun_machinery_small_mesh`) on the port: olmo-1b `train_4k` and
    rwkv6-3b `decode_32k`, full size, on a fake (2, 4) group;
  * against JAX's compiled cells (`lower_cell` + `compile_and_analyze` on
    8 host devices, in a subprocess): the argument bytes leaf by leaf, and
    olmo-1b `train_4k`'s flops a rank within a stated limit;
  * the counter on one DTensor matmul: the rank's local flops and one
    all-gather, the same on a second call (DTensor's sharding cache warm);
  * K9 and K8's custom ops under fake tensors: the outputs' shapes and
    dtypes, exactly the formulas' bytes and flops, no (T, T) scores in the
    count or the peak;
  * decode and prefill on 4 gloo ranks (`tests/torch_mesh_ranks.py:
    serve_archs`) against the port's single-device results;
  * `run_lm_cells` writes a record, skips it when cached, and reports a
    failing cell; `main` runs the LM cells.

The rank runs and JAX's subprocess start in the module's fixture and run
while this process traces the two full-size cells.
"""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import get_arch, reduce_arch  # noqa: E402
from repro_torch.distributed import spawn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun, lm_dryrun  # noqa: E402
from repro_torch.launch.mesh import (init_fake_group, make_mesh,  # noqa: E402
                                     small_spec)
from repro_torch.models.rwkv import RwkvCfg  # noqa: E402
from repro_torch.roofline import kernels as rk  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPEC = small_spec(2, 4)
CELLS = (("olmo-1b", "train_4k"), ("rwkv6-3b", "decode_32k"))
# The port's flops a rank of olmo-1b train_4k over JAX's `hlo.flops`, read
# on this cell: 1.694e15 / 1.875e15 = 0.90 (1.52 while the MLP ran on
# DTensor's own strategies, which on torch 2.13 computed the whole hidden
# dim on every "model" rank).  Two parts pull apart.  JAX lowers attention
# through `flash_attention_xla` on host devices (its `models/layers.py:101`;
# the model never takes the Pallas kernel's dispatch): full key blocks, the
# mask applied after the products, so each forward call counts 4 d T^2 a
# head where K9's formula counts the causal half (JAX counts more).  The
# port runs each sub-layer's forward three times under two-level remat (the
# forward, the group's recompute, and inside it each sub-layer's checkpoint
# again), where XLA's program runs it about twice (the port counts more).
# The limit brackets the reading by 0.1 either side.
FLOPS_RATIO = (0.80, 1.00)
# decode and prefill on the mesh against one device, of max |ref|: the
# mesh tests' step tolerance (tests/test_torch_lm_mesh.py: STEP_TOL)
MESH_TOL = 1e-5
RANK_TIMEOUT_S = 600

JAX_CELLS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
from repro.launch import dryrun
from repro.launch.mesh import make_test_mesh
mesh = make_test_mesh(2, 4)
out = {}
for arch, shape in json.loads(sys.argv[1]):
    lowered, aux = dryrun.lower_cell(arch, shape, mesh)
    rec = dryrun.compile_and_analyze(lowered, aux, mesh, verbose=False)
    infos = jax.tree_util.tree_flatten_with_path(lowered.args_info[0])[0]
    shardings = jax.tree_util.tree_leaves(lowered.compile().input_shardings[0])
    leaves = {jax.tree_util.keystr(p): [int(np.prod(s.shard_shape(a.shape))),
                                        np.dtype(a.dtype).itemsize]
              for (p, a), s in zip(infos, shardings)}
    out[f"{arch}/{shape}"] = dict(memory=rec["memory"], hlo=rec["hlo"],
                                  leaves=leaves, n_params=rec["n_params"],
                                  model_flops=rec["model_flops"])
print("JAX_CELLS " + json.dumps(out))
"""


def _jax_cells():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("JAX_ENABLE_X64", None)
    return subprocess.run([sys.executable, "-c", JAX_CELLS, json.dumps(CELLS)],
                          capture_output=True, text=True, timeout=600, env=env,
                          cwd=str(ROOT))


def _arch(name: str, n_layers: int = 2):
    a = reduce_arch(get_arch(name))
    if name == "rwkv6-3b":     # heads of 16: four heads, which "model" splits
        a = dataclasses.replace(a, rwkv=RwkvCfg(head_dim=16))
    return dataclasses.replace(a, n_layers=n_layers)


def _serve_case() -> dict:
    """olmo-1b and rwkv6-3b at 2 layers (B 4: prefill, and decode with the
    KV sequence over "model"), olmo-1b at batch 1 (the sequence over both
    axes, as long_500k lays it) and jamba at its 8-layer program (the
    mamba step under local_map, the MoE decode pin)."""
    rng = np.random.default_rng(0)
    archs = {}
    for name, B in (("olmo-1b", 4), ("rwkv6-3b", 4), ("olmo-1b/b1", 1),
                    ("jamba-1.5-large-398b", 4)):
        base = name.split("/")[0]
        a = _arch(base, 8 if base.startswith("jamba") else 2)
        archs[name] = dict(arch=a, B=B, max_len=8,
                           steps=rng.integers(0, a.vocab, (6, B, 1)))
        if B > 1:
            archs[name]["prompt"] = rng.integers(0, a.vocab, (B, 8))
    return dict(shape=(2, 2), archs=archs)


@pytest.fixture(scope="module")
def runs():
    """The two full-size traces (this process), JAX's compiled cells (a
    subprocess) and the mesh's decode and prefill (4 gloo ranks)."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jax_run = pool.submit(_jax_cells)
        ranks = pool.submit(spawn.run, R.serve_archs, 4,
                            timeout_s=RANK_TIMEOUT_S, args=(_serve_case(),))
        recs = {c: lm_dryrun.trace_cell(*c, SPEC, device="cpu") for c in CELLS}
        res = jax_run.result()
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith("JAX_CELLS ")]
        assert line, res.stdout[-2000:] + res.stderr[-2000:]
        jax = json.loads(line[0][len("JAX_CELLS "):])
        served = ranks.result()
    return dict(recs=recs, jax=jax, served=served)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "/".join(c))
def test_dryrun_machinery_small_mesh(runs, cell):
    """JAX's machinery test, on the port's record."""
    rec = runs["recs"][cell]
    ro = rec["roofline"]
    assert rec["memory"]["peak_per_device"] > 0
    assert ro["memory_s"] > 0
    assert ro["dominant"] in ("compute", "memory", "collective")
    if cell[1] == "train_4k":
        assert ro["compute_s"] > 0 and 0.05 < ro["useful_ratio"] <= 1.2
    for key in ("arch", "shape", "n_params", "n_params_active", "model_flops",
                "mesh_shape", "chips", "memory", "cost_analysis", "hlo",
                "roofline", "trace_s", "machine", "dtype", "device", "n_ops",
                "kernels"):
        assert key in rec, key
    assert (rec["mesh_shape"], rec["chips"], rec["dtype"]) == ([2, 4], 8, "bf16")


def _group_name(key: str, shape: str) -> str:
    """JAX's keystr of an argument leaf ("[i]...") as the port's name."""
    groups = (("params", "opt", "batch") if shape == "train_4k"
              else ("params", "cache", "tokens"))
    i = int(key[1:key.index("]")])
    return groups[i] + key[key.index("]") + 1:]


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "/".join(c))
def test_arguments_are_jax_shards(runs, cell):
    """Every argument leaf a rank holds (parameters, moments, batch; or
    parameters, cache, tokens) has JAX's per-device bytes, and so the sum;
    the rank's arguments are JAX's `argument_bytes` (decode's position is
    an argument of neither program)."""
    rec, jax = runs["recs"][cell], runs["jax"]["/".join(cell)]
    got = rec["memory"]["arguments"]
    want = {_group_name(k, cell[1]): v for k, v in jax["leaves"].items()}
    assert list(got) == list(want)
    diffs = {n: (got[n]["bytes"], e * i) for n, (e, i) in want.items()
             if got[n]["bytes"] != e * i}
    assert diffs == {}
    assert rec["memory"]["argument_bytes"] == jax["memory"]["argument_bytes"]
    assert (rec["n_params"], rec["model_flops"]) == (jax["n_params"],
                                                     jax["model_flops"])


def test_train_flops_within_the_stated_limit_of_jax(runs):
    """olmo-1b train_4k's flops a rank against JAX's dot-parsed `hlo.flops`
    (FLOPS_RATIO, from the reading); its attention's part is tagged
    `flash_attention`, K9's forward by its causal formula."""
    rec = runs["recs"][CELLS[0]]
    jflops = runs["jax"]["/".join(CELLS[0])]["hlo"]["flops"]
    ratio = rec["hlo"]["flops"] / jflops
    assert FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1], ratio
    k9 = rec["kernels"]["flash_attention"]
    (call,) = k9["shapes"]
    BH, T, d = call["shapes"][0]
    assert (BH, T, d) == (128 * 4, 4096, 128)      # (B / 2) * (16 / 4) heads
    assert k9["flops"] == k9["calls"] * 4 * d * BH * T * (T + 1) // 2
    # the forward JAX counts, full blocks, against K9's causal formula
    full = k9["calls"] * 4 * d * BH * T * T
    assert full > k9["flops"]
    assert rec["hlo"]["flops_by_source"]["flash_attention"] >= k9["flops"]


def test_records_tag_the_gathers_jax_lacks(runs):
    """The gathers JAX lacks are gone: the embedding and the loss keep the
    vocab split, as JAX's program does, and are reported under their own
    tags, in bytes and collective bytes.  The lookup gathers only the
    rank's vocab shard over "data" (its FSDP shards: V / 4 x D bf16, not
    the whole table); the loss moves three all-reduces of a (B / 2) x 4095
    float32 row statistic, not the logits.  The peak, 548.2 GB while the
    loss gathered the whole-vocab float32 logits, reads 113.15 GB against
    JAX's 114.7 GB.  Decode's record holds K8's call nowhere (decode steps
    the state in plain torch)."""
    rec = runs["recs"][CELLS[0]]
    for tag in ("layers.embed_lookup", "layers.token_nll"):
        assert rec["hlo"]["bytes_by_source"][tag] > 0, tag
    coll = rec["hlo"]["coll_by_source"]
    assert coll["layers.embed_lookup"] == 50304 // 4 * 2048 * 2
    assert coll["layers.token_nll"] == 3 * 2 * 128 * 4095 * 4
    peak = rec["memory"]["peak_per_device"]
    assert peak < 548.2e9
    assert peak <= 1.05 * runs["jax"]["/".join(CELLS[0])]["memory"][
        "peak_per_device"], peak
    assert sum(rec["hlo"]["coll_by_kind"].values()) == rec["hlo"]["coll_bytes"]
    dec = runs["recs"][CELLS[1]]
    assert dec["kernels"] == {}
    assert dec["options"] == {"seq_parallel": False}


@pytest.mark.parametrize("name", ["olmo-1b", "rwkv6-3b", "olmo-1b/b1",
                                  "jamba-1.5-large-398b"])
def test_decode_and_prefill_on_a_mesh_match_one_device(runs, name):
    errs = runs["served"][0][name]
    for key in ("prefill", "decode", "cache"):
        if key in errs:
            assert errs[key] <= MESH_TOL, (key, errs[key])
    # every rank holds a block of the cache: the batch and the sequence
    for rank in runs["served"]:
        local = rank[name]["cache_local"]
        if name.startswith("olmo"):
            B = 4 if name == "olmo-1b" else 1
            k = local["['sub0']['k']"]
            assert k[1:3] == ((B // 2, 4) if B > 1 else (1, 2)), k


@pytest.mark.parametrize("inplace", [False, True])
def test_adamw_on_zero1_moments_matches_one_device(runs, inplace):
    """AdamW with moments split further than their parameter (JAX's
    ZeRO-1 layout, which the dry run's train cells take) gives one
    device's step, and the parameter keeps its placements."""
    got = runs["served"][0]["zero1"][inplace]
    assert got["err"] <= 1e-6, got
    assert got["placements"] == "(Replicate(), Shard(dim=1))", got


# ---------------------------------------------------------------------------
# the counter and the custom ops, small
# ---------------------------------------------------------------------------
def _fake_dtensor(shape, placements, mesh, fake_mode):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local_shape, _ = compute_local_shape_and_global_offset(shape, mesh,
                                                           placements)
    with fake_mode:
        local = torch.empty(local_shape)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=(shape[1], 1))


def test_counter_sees_one_rank_of_a_dtensor_matmul():
    """x (256, 4096) at [Shard(0), Replicate()] @ w (4096, 4096) at
    [Shard(0), Shard(1)] on (2, 4): the rank gathers x's rows (one
    all-gather of its (128, 4096) float32 rows, JAX's bytes: the gathered
    result) and multiplies (256, 2048) by (2048, 1024); DTensor's
    propagation at the global shape is not counted, and a second matmul,
    its sharding cached, counts the same."""
    from torch.distributed.tensor import Replicate, Shard
    init_fake_group(SPEC.size)
    try:
        mesh = make_mesh(SPEC, "cpu")
        fm = FakeTensorMode(allow_non_fake_inputs=True)
        x = _fake_dtensor((256, 4096), (Shard(0), Replicate()), mesh, fm)
        w = _fake_dtensor((4096, 4096), (Shard(0), Shard(1)), mesh, fm)
        counts = []
        for _ in range(2):
            c = lm_dryrun.RankCounter()
            with lm_dryrun._propagation_marked(c), c:
                y = x @ w
            counts.append((c.stats.flops, dict(c.stats.coll_by_kind),
                           c.stats.n_collectives))
        assert counts[0] == counts[1]
        flops, kinds, n = counts[0]
        assert flops == 2 * 256 * 2048 * 1024
        assert (kinds, n) == ({"all-gather": 2 * 128 * 4096 * 4}, 1)
        assert tuple(y.to_local().shape) == (256, 1024)
    finally:
        dist.destroy_process_group()


def _traced(fn, *args):
    """fn(*args) under a RankCounter, the tap and a MemTracker: (outputs,
    counter, peak bytes)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    c, mt = lm_dryrun.RankCounter(), MemTracker()
    mt.track_external(*args)
    with mt, c, ops.tapped(c.kernel):
        out = fn(*args)
    peak = max(v.get("Total", 0) for v in
               mt.get_tracker_snapshot("peak").values())
    return out, c, peak


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_attention_custom_op_under_fake_tensors(backend, stats):
    """K9 on fake tensors through the custom op on either backend (fake
    CPU tensors stand for the card's: only the op's fake runs): the
    outputs' shapes and dtypes, the formula's bytes and flops and nothing
    else, no (T, T) scores in the peak."""
    BH, T, d, window = 6, 512, 64, 100
    fm = FakeTensorMode()
    with fm:
        q, k, v = (torch.empty(BH, T, d, dtype=torch.bfloat16)
                   for _ in range(3))
    fn = ops.attention_with_stats if stats else ops.attention
    bk = backend if backend == "plain" else None
    if backend == "cuda":       # a fake CUDA tensor needs no card
        with fm:
            q, k, v = (torch.empty(BH, T, d, dtype=torch.bfloat16,
                                   device="cuda") for _ in range(3))
    out, c, peak = _traced(lambda *a: fn(*a, causal=True, window=window,
                                         backend=bk), q, k, v)
    outs = out if stats else (out,)
    assert [(tuple(o.shape), o.dtype) for o in outs] == \
        [((BH, T, d), torch.bfloat16)] + ([((BH, T), torch.float32)] * 2
                                           if stats else [])
    cost = rk.flash_attention(q, k, v, True, window, None, stats)
    assert (c.stats.bytes, c.stats.flops, c.n_ops) == (cost.bytes, cost.flops, 0)
    assert cost.flops == 4 * d * BH * rk.attention_pairs(T, T, True, window)
    assert c.launches["flash_attention"] == 1
    assert peak <= rk.nbytes(q, k, v, *outs)
    assert peak < BH * T * T * 4


def test_wkv6_custom_op_under_fake_tensors():
    BH, T, K, H = 8, 256, 64, 4
    with FakeTensorMode():
        r, k, v, w = (torch.empty(BH, T, K) for _ in range(4))
        u = torch.empty(H, K)
    out, c, peak = _traced(lambda *a: ops.wkv6(*a, backend="plain"),
                           r, k, v, w, u)
    assert (tuple(out.shape), out.dtype) == ((BH, T, K), torch.float32)
    assert (c.stats.bytes, c.stats.flops, c.n_ops) == (
        rk.nbytes(r, k, v, w, u, v), (5 * K * K + 5 * K) * T * BH, 0)
    assert peak <= rk.nbytes(r, k, v, w, u, out)
    assert dict(c.launches) == {"wkv6": 1}


def test_custom_ops_on_cpu_tensors_are_the_plain_versions():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(3, 40, 16, generator=g) for _ in range(3))
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv6 as kw
    assert torch.equal(torch.ops.repro_torch.flash_attention(q, k, v, True, 8, 5.0),
                       fa.flash_attention_plain(q, k, v, True, 8, 5.0))
    for a, b in zip(torch.ops.repro_torch.flash_attention_stats(q, k, v, False,
                                                                None, None),
                    fa.flash_attention_plain(q, k, v, False, stats=True)):
        assert torch.equal(a, b)
    w = torch.rand(3, 40, 16, generator=g)
    u = torch.randn(16, generator=g)
    assert torch.equal(torch.ops.repro_torch.wkv6(q, k, v, w, u),
                       kw.wkv6_plain(q, k, v, w, u))


def _scan(name: str, xs: list):
    """Mamba's selective scan or the chunked WKV on xs (the scan's inputs)."""
    from repro_torch.models import mamba, rwkv
    if name == "mamba":
        return mamba._ssm_scan(*xs)
    return rwkv.wkv_chunked(*xs)[0]


SCAN_SHAPES = {     # 16 chunks: mamba's of 32 steps, WKV's of 64
    "mamba": [(2, 512, 8)] * 2 + [(2, 512, 4)] * 2 + [(8, 4), (8,)],
    "wkv": [(6, 1024, 8)] * 4 + [(6, 8)]}


@pytest.mark.parametrize("name", list(SCAN_SHAPES))
def test_scan_traced_one_chunk_counts_every_chunk(name):
    """On fake tensors mamba's `_ssm_scan` and `rwkv.wkv_chunked` trace one
    chunk for its trip count (`layers.traced_chunks`): their bytes and
    flops, forward and backward, are the loop's over every chunk on real
    tensors within 1 %, their ops within 15 % (read: mamba 0.02 %, 0.06 %,
    0.08 % of the ops; WKV 0.8 %, 0.9 %, 11.3 %: the loop's per-chunk
    slices and casts around the checkpointed body, which the traced chunk
    does not repeat, are many small ops)."""
    counts = {}
    for fake in (False, True):
        shapes = SCAN_SHAPES[name]
        if fake:       # as the dry run's: the loop's masks are real tensors
            with FakeTensorMode(allow_non_fake_inputs=True):
                xs = [torch.empty(s, requires_grad=True) for s in shapes]
        else:
            xs = [torch.rand(s, requires_grad=True) for s in shapes]
        c = lm_dryrun.RankCounter()
        with c:
            y = _scan(name, xs)
            torch.autograd.grad(y.sum(), xs)
        counts[fake] = (c.stats.bytes, c.stats.flops, c.n_ops)
        assert tuple(y.shape) == shapes[0]
    for traced, looped, limit in zip(counts[True], counts[False],
                                     (0.01, 0.01, 0.15)):
        assert abs(traced - looped) <= limit * looped, counts


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_run_lm_cells_writes_skips_and_reports(tmp_path, monkeypatch, capsys):
    """`run_lm_cells` on a reduced olmo-1b under a test name: writes the
    record, skips it when cached, reports a failing cell and goes on;
    `main` traces the LM cells (it no longer exits 2 without --ocean)."""
    from repro_torch import configs
    tiny = dataclasses.replace(_arch("olmo-1b"), name="tiny-olmo")
    monkeypatch.setitem(configs.ALL_ARCHS, "tiny-olmo", tiny)
    specs = {"test": SPEC}
    assert dryrun.run_lm_cells(["tiny-olmo"], ["prefill_32k"], specs,
                               str(tmp_path), device="cpu") == []
    path = tmp_path / "test" / "tiny-olmo__prefill_32k.json"
    rec = json.loads(path.read_text())
    assert (rec["arch"], rec["shape"], rec["chips"]) == ("tiny-olmo",
                                                         "prefill_32k", 8)
    assert rec["kernels"]["flash_attention"]["calls"] == 2
    assert dryrun.run_lm_cells(["tiny-olmo"], ["prefill_32k"], specs,
                               str(tmp_path), device="cpu") == []
    assert "[skip] test/tiny-olmo_prefill_32k (cached)" in capsys.readouterr().out
    fails = dryrun.run_lm_cells(["tiny-olmo", "no-such-arch"], ["prefill_32k"],
                                specs, str(tmp_path / "x"), device="cpu")
    assert [t for t, _ in fails] == ["test/no-such-arch_prefill_32k"]
    assert (tmp_path / "x" / "test" / "tiny-olmo__prefill_32k.json").exists()
    monkeypatch.setattr(dryrun, "production_spec", lambda multi_pod: SPEC)
    dryrun.main(["--arch", "tiny-olmo", "--shape", "decode_32k", "--mesh",
                 "single", "--device", "cpu", "--out", str(tmp_path / "m")])
    assert (tmp_path / "m" / "single_pod" / "tiny-olmo__decode_32k.json").exists()
    assert "all cells traced" in capsys.readouterr().out
