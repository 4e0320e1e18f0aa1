"""The port's ocean dry run (`repro_torch.launch.ocean_dryrun.trace_ocean`,
`launch/dryrun.py`) against the JAX package's, on the CPU.

A small cell (`rect_mesh(16, 16)`, 512 triangles, 4 layers, m_2d 4) on a
fake group of (2, 4) = 8 ranks, at halo exchange periods 0 and 2:
  * n_own and n_loc of rank 0 equal JAX's `partition.build_partition`;
  * the exchanges and bytes of the counted step equal the closed forms
    for the cell's ring offsets, nl and period, in the tests' own copy
    (`tests/torch_dist_ranks.py`); `distributed/halo.py`'s, which
    chip_smoke.py holds its records to, equal both and the values worked
    out by hand for this cell;
  * the kernels' calls and launches a step equal the step's registry;
  * the record's float arguments (geometry, b, state) equal, leaf by leaf,
    the per-device bytes of JAX's `DistributedOcean.abstract_args()` for
    the same cell on 8 host devices (in a subprocess that compiles
    nothing); the integer leaves (the geometry's neighbour tables and the
    halo tables) hold equal element counts, int64 in the port against
    int32 in JAX, so their bytes are twice JAX's;
  * the peak is positive, the dominant term named, the kernels' bytes
    tagged by their source;
  * `run_ocean_cells` writes a record, skips it when cached, and `rederive`
    over the directory leaves it equal (the LM cells' CLI:
    `tests/test_torch_lm_dryrun.py`);
  * the fake group's transport moves no data: a shift returns a copy;
  * `return_state` gives the counted step's state, on either backend.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro.core import mesh2d as jmesh  # noqa: E402
from repro.distributed import partition as jpart  # noqa: E402
from repro_torch.distributed import halo  # noqa: E402
from repro_torch.launch import dryrun, ocean_dryrun  # noqa: E402
from repro_torch.launch.mesh import init_fake_group, small_spec  # noqa: E402
from repro_torch.roofline import rederive  # noqa: E402

import torch_dist_ranks as R  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPEC = small_spec(2, 4)
CELL = dict(name="small", nx=16, ny=16, lx=16e3, ly=16e3, nl=4, m_2d=4,
            dt=30.0, depth=20.0)
PERIODS = (0, 2)
# launches of each kernel in one step (both stages): K1, K2, K3, K4, K7
PER_STEP = {"solve_r": 2, "solve_w": 2, "block_thomas": 2, "lateral_flux": 4,
            "tridiag": 4}


def cell(period: int) -> ocean_dryrun.OceanCell:
    return ocean_dryrun.OceanCell(**CELL, halo_exchange_period=period)


@pytest.fixture(scope="module")
def records():
    return {p: ocean_dryrun.trace_ocean(cell(p), SPEC, device="cpu")
            for p in PERIODS}


JAX_ARGS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
from repro.launch import ocean_dryrun as jdry
from repro.launch.mesh import make_test_mesh
mesh = make_test_mesh(2, 4)
out = {}
for period in (0, 2):
    kw = json.loads(sys.argv[1])
    do = jdry.build_cell(jdry.OceanCell(**kw, halo_exchange_period=period), mesh)
    leaves = jax.tree_util.tree_flatten_with_path(do.abstract_args())[0]
    out[period] = {jax.tree_util.keystr(p): [int(np.prod(x.shape[1:])),
                                             x.dtype.itemsize, x.shape[0]]
                   for p, x in leaves}
print("JAX_ARGS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_args():
    """{period: {JAX keystr: [elements a device, itemsize, leading axis]}}
    of JAX's abstract arguments, from a subprocess on 8 host devices."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("JAX_ENABLE_X64", None)
    res = subprocess.run([sys.executable, "-c", JAX_ARGS, json.dumps(CELL)],
                         capture_output=True, text=True, timeout=300, env=env,
                         cwd=str(ROOT))
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("JAX_ARGS ")]
    assert line, res.stdout[-2000:] + res.stderr[-2000:]
    return {int(k): v for k, v in json.loads(line[0][9:]).items()}


@pytest.mark.parametrize("period", PERIODS)
def test_partition_is_jax_partition(records, period):
    m = jmesh.rect_mesh(CELL["nx"], CELL["ny"], CELL["lx"], CELL["ly"],
                        jitter=0.2, seed=7)
    jspec = jpart.build_partition(m, SPEC.size, max(1, 3 * period))
    part = records[period]["partition"]
    assert (part["n_own"], part["n_loc"]) == (jspec.n_own, jspec.n_loc)
    assert part["offsets"] == sorted(jspec.tables)
    assert part["msg"] == [jspec.tables[o][0].shape[1]
                           for o in sorted(jspec.tables)]


@pytest.mark.parametrize("period", PERIODS)
def test_halo_counts_are_the_closed_forms(records, period):
    rec = records[period]
    part, hlo = rec["partition"], rec["hlo"]
    assert hlo["n_collectives"] == R.shifts_per_step(
        len(part["offsets"]), period, CELL["m_2d"])
    assert hlo["coll_bytes"] == R.bytes_per_step(
        part["msg"], period, 4, CELL["m_2d"], CELL["nl"])
    assert hlo["coll_by_kind"] == {"collective-permute": hlo["coll_bytes"]}
    assert rec["roofline"]["n_collectives"] == hlo["n_collectives"]


# rank 0's message sizes of the small cell (one a ring offset: 1, 2, 3, 5,
# 6, 7) and its exchanges and float32 bytes a step, worked out by hand:
# period 0: (5 + 3 * 2) + (5 + 3 * 4) = 28 shifts an offset, 18 of them of
# the 2D state; 32 slots * 4 B * (2 * (4 * 4 * 6 + 3) + 9 * 18) = 46,080;
# period 2: (5 + 1) + (5 + 2) = 13, 3 of the 2D state;
# 212 * 4 * (198 + 27) = 190,800
CLOSED = {0: ([8, 4, 4, 4, 4, 8], 168, 46080),
          2: ([48, 34, 24, 24, 34, 48], 78, 190800)}


@pytest.mark.parametrize("period", PERIODS)
def test_halo_closed_forms_are_pinned(records, period):
    msg, shifts, moved = CLOSED[period]
    assert records[period]["partition"]["msg"] == msg
    nl, m_2d = CELL["nl"], CELL["m_2d"]
    assert halo.shifts_per_step(len(msg), period, m_2d) == shifts
    assert R.shifts_per_step(len(msg), period, m_2d) == shifts
    assert halo.bytes_per_step(msg, period, nl, 4, m_2d) == moved
    assert R.bytes_per_step(msg, period, 4, m_2d, nl) == moved


@pytest.mark.parametrize("period", PERIODS)
def test_kernel_launches_are_the_registry(records, period):
    kernels = records[period]["kernels"]
    assert {k: v["launches"] for k, v in kernels.items()} == PER_STEP
    assert {k: v["calls"] for k, v in kernels.items()} == PER_STEP
    src = records[period]["hlo"]["bytes_by_source"]
    for name in ("solve_r", "solve_w", "block_thomas"):
        assert src[name] == kernels[name]["bytes"]
    assert records[period]["hlo"]["bytes"] == sum(src.values())


def _jax_name(key: str) -> str:
    group = ("geom", "b", "tables", "state")[int(key[1])]
    return group + key[3:]


@pytest.mark.parametrize("period", PERIODS)
def test_arguments_are_jax_abstract_args(records, jax_args, period):
    got = records[period]["memory"]["arguments"]
    want = {_jax_name(k): v for k, v in jax_args[period].items()}
    assert list(got) == list(want)
    for name, (elements, itemsize, lead) in want.items():
        assert lead == SPEC.size, name
        assert got[name]["elements"] == elements, name
        if name.startswith("tables") or name.split(".")[-1] in (
                "ext_tri", "ext_na", "ext_nb"):
            # int64 in the port, int32 in JAX
            assert (itemsize, got[name]["bytes"]) == (4, 8 * elements), name
        else:
            assert itemsize == 4, name
            assert got[name]["bytes"] == elements * itemsize, name
    mem = records[period]["memory"]
    assert mem["argument_bytes"] == sum(a["bytes"] for a in got.values())
    state = sum(a["bytes"] for n, a in got.items() if n.startswith("state"))
    assert mem["output_bytes"] == state


@pytest.mark.parametrize("period", PERIODS)
def test_record_has_jax_keys_and_a_roofline(records, period):
    rec = records[period]
    for key in ("arch", "shape", "n_triangles", "n_layers", "model_flops",
                "mesh_shape", "chips", "memory", "cost_analysis", "hlo",
                "roofline", "trace_s", "machine", "device", "dtype"):
        assert key in rec, key
    assert (rec["mesh_shape"], rec["chips"]) == ([2, 4], 8)
    assert (rec["machine"], rec["device"], rec["dtype"]) == ("H100_SXM", "cpu",
                                                            "f32")
    assert rec["n_triangles"] == 512 and rec["n_layers"] == 4
    assert rec["memory"]["peak_per_device"] > rec["memory"]["argument_bytes"]
    ro = rec["roofline"]
    assert ro["dominant"] in ("compute", "memory", "collective")
    assert ro["memory_s"] > 0 and ro["compute_s"] > 0
    assert rec["n_ops"] > 0 and "card" not in rec


def test_run_ocean_cells_writes_skips_and_rederives(tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.setitem(ocean_dryrun.OCEAN_CELLS, "small", cell(0))
    specs = {"test": SPEC}
    assert dryrun.run_ocean_cells(specs, str(tmp_path), ["small"],
                                  device="cpu") == []
    path = tmp_path / "test" / "ocean-small.json"
    first = json.loads(path.read_text())
    assert first["partition"]["n_own"] == 64
    assert dryrun.run_ocean_cells(specs, str(tmp_path), ["small"],
                                  device="cpu") == []
    assert "[skip] test/ocean-small (cached)" in capsys.readouterr().out
    assert rederive.main(str(tmp_path)) == 1
    assert json.loads(path.read_text()) == first
    # a failing cell is reported and the sweep goes on
    assert [t for t, _ in dryrun.run_ocean_cells(
        specs, str(tmp_path / "x"), ["no-such-cell"], device="cpu")] == [
        "test/ocean-no-such-cell"]


def test_fake_group_transport_moves_no_data():
    init_fake_group(256)
    try:
        assert (dist.get_world_size(), dist.get_rank()) == (256, 0)
        tr = halo.Transport()
        assert (tr.mode, tr.size) == ("fake", 256)
        buf = torch.arange(12.0).reshape(3, 4)
        got = tr.shift(buf, 5)
        assert torch.equal(got, buf)
        assert got.data_ptr() != buf.data_ptr()
        with pytest.raises(RuntimeError):
            init_fake_group(8)
    finally:
        dist.destroy_process_group()


def test_trace_ocean_returns_the_counted_state(records):
    """`return_state` gives rank 0's state after the counted step: the
    same record, a state that a second trace reproduces bitwise, and on
    the ref backend (nothing inside a kernel body, so no kernel counted)
    a finite state whose T and S lie within 1e-4 of plain's."""
    rec, st = ocean_dryrun.trace_ocean(cell(0), SPEC, device="cpu",
                                       return_state=True)
    for key in ("partition", "hlo", "kernels"):
        assert rec[key] == records[0][key], key
    _, again = ocean_dryrun.trace_ocean(cell(0), SPEC, device="cpu",
                                        return_state=True)
    ref, ref_st = ocean_dryrun.trace_ocean(cell(0), SPEC, device="cpu",
                                           backend="ref", return_state=True)
    assert ref["kernels"] == {}
    for name in ("T", "S", "ux", "turb_k", "nu_t"):
        x = getattr(st, name)
        assert x.shape[-1] == rec["partition"]["n_loc"], name
        assert torch.equal(x, getattr(again, name)), name
        assert bool(torch.isfinite(getattr(ref_st, name)).all()), name
    for name in ("T", "S"):
        x, y = getattr(st, name), getattr(ref_st, name)
        assert float((x - y).abs().max()) <= 1e-4 * float(x.abs().max()), name


def test_trace_ocean_refuses_another_group():
    init_fake_group(4)
    try:
        with pytest.raises(RuntimeError, match="fake group of 8"):
            ocean_dryrun.trace_ocean(cell(0), SPEC, device="cpu")
    finally:
        dist.destroy_process_group()
