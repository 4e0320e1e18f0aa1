"""The run of a cell on several ranks (`bench/ranks.py`), on the CPU over
gloo at the small mesh: the gathered state against the one-device
reference, the timed path broken underneath on the ranks, a rank that
raises or hangs, and the inputs and initial state every rank builds.
`front-f64.nl16-m20` runs as its ranks: a cell of four chips shares its
configuration, traffic and limits."""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import harness, inputs, ranks, run, sides, spec
from bench.tests import tiny

CELL = "front-f64.nl16-m20"
HALO = ("halo_shifts_per_step", "halo_mb_per_step", "halo_device_ms_per_step")
DEADLINE_S = 20.0


def _rank_children() -> list:
    """Live processes that this one started by the spawn method."""
    me, out = os.getpid(), []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            stat = (d / "stat").read_text()
            cmd = (d / "cmdline").read_bytes()
        except OSError:
            continue
        fields = stat.rsplit(")", 1)[1].split()
        if int(fields[1]) == me and fields[0] != "Z" \
                and b"multiprocessing" in cmd:
            out.append(int(d.name))
    return out


def _read_halo(mods, rank):
    """The cell's per-layer metrics and the halo exchange's."""
    real = spec.metrics_of

    def metrics_of(workload, section):
        extra = [{"name": n, "unit": "1"} for n in HALO] \
            if section == "per_layer" else []
        return real(workload, section) + extra
    spec.metrics_of = metrics_of


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_gathered_state_matches_the_reference(n_ranks):
    out = tiny.run_ranks(CELL, n_ranks=n_ranks, traced=n_ranks == 4,
                         patch=_read_halo)
    assert out["correct"], out["checks"]
    assert max(c["value"] for c in out["checks"].values()) < 1e-9
    assert out["device"]["count"] == n_ranks
    assert len(out["device"]["memory_peak_bytes_by_rank"]) == n_ranks
    assert out["attempted"] == 3 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    if n_ranks == 4:
        closed = out["ranks"]["halo_shifts_per_step_closed_form"]
        assert closed == 100 * out["ranks"]["ring_offsets"]
        assert out["metrics"]["halo_shifts_per_step"]["value"] == closed
        assert out["metrics"]["halo_mb_per_step"]["value"] > 0
        dev = out["device"]
        assert dev["busy_s"] == pytest.approx(
            sum(dev["busy_s_by_rank"]) / 4)
        assert dev["window_s"] == pytest.approx(
            sum(dev["window_s_by_rank"]) / 4)
        assert not _rank_children()


# --- the timed path broken underneath, on every rank ------------------------

def _halo_left_out(mods, rank):
    """The exchange between the ranks left out: every halo keeps the
    values it was scattered with."""
    mods.halo._refresh_ = lambda x, tables, transport: x


def _wrap_step(mods, fault):
    real = mods.stepper.step

    def step(geom, vg, cfg, st, forcing, **hooks):
        new = real(geom, vg, cfg, st, forcing, **hooks)
        return fault(geom, st, new)
    mods.stepper.step = step


def _unchanged(mods, rank):
    _wrap_step(mods, lambda geom, st, new: st)


def _half_left_out(mods, rank):
    def fault(geom, st, new):
        half = geom.nt // 2
        for name in ("ux", "uy", "T", "S", "turb_k", "turb_eps", "nu_t",
                     "kappa_t"):
            getattr(new, name)[..., half:] = getattr(st, name)[..., half:]
        return new
    _wrap_step(mods, fault)


def _altered(mods, rank):
    def fault(geom, st, new):
        if rank != 0:
            return new
        T = new.T.clone()
        T[0, 0, 0] *= 1 + 1e-4
        return dataclasses.replace(new, T=T)
    _wrap_step(mods, fault)


@pytest.mark.parametrize("fault", [_halo_left_out, _unchanged,
                                   _half_left_out, _altered],
                         ids=["halo_left_out", "unchanged", "half_left_out",
                              "altered"])
def test_a_broken_rank_path_is_not_correct(fault):
    out = tiny.run_ranks(CELL, n_ranks=2, patch=fault)
    assert not out["correct"], out["checks"]


# --- a rank that fails ends the run -----------------------------------------

def _raises(mods, rank):
    if rank == 1:
        raise RuntimeError("rank 1 planted fault")


def _hangs(mods, rank):
    if rank == 1:
        time.sleep(600)


def test_a_rank_that_raises_ends_the_run():
    t0 = time.perf_counter()
    with pytest.raises(ranks.RankFailure, match="rank 1 planted fault"):
        tiny.run_ranks(CELL, n_ranks=4, patch=_raises, deadline_s=DEADLINE_S)
    assert time.perf_counter() - t0 < DEADLINE_S
    assert not _rank_children()


def test_a_rank_that_hangs_ends_at_the_deadline():
    t0 = time.perf_counter()
    with pytest.raises(ranks.RankFailure, match="did not finish"):
        tiny.run_ranks(CELL, n_ranks=4, patch=_hangs, deadline_s=DEADLINE_S)
    assert time.perf_counter() - t0 < DEADLINE_S + 15
    assert not _rank_children()


def test_bench_run_exits_non_zero_on_a_failed_rank(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    real_workload = spec.workload
    monkeypatch.setattr(spec, "workload",
                        lambda name: {**real_workload(name), "chips": 4})
    real = ranks.run_cell

    def on_the_cpu(workload, seed, seconds, traced, n_ranks, t_start):
        # the module's start time is this test session's
        return real(workload, seed, seconds, traced, n_ranks,
                    time.perf_counter(),
                    placement="cpu", deadline_s=DEADLINE_S,
                    overrides=tiny.overrides(workload), patch=_raises)
    monkeypatch.setattr(ranks, "run_cell", on_the_cpu)
    rc = run.main(["--workload", CELL, "--seed", "3000000001", "--seconds",
                   "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "rank 1 planted fault" in out.err
    assert not _rank_children()


# --- what every rank builds ------------------------------------------------

def _inputs_digest(rank, n_ranks, device, marks, workload, seed,
                   overrides):
    case, traffic, _, _ = harness.load(workload, overrides)
    inp = inputs.make_inputs(case, traffic, seed, device)
    h = hashlib.sha256()
    for a in (inp.mesh.xy, inp.mesh.tri, inp.mesh.neigh_tri,
              inp.mesh.neigh_edge, inp.mesh.edge_type, inp.b,
              inp.eta.numpy(), inp.T.numpy()):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(repr((inp.nl, inp.m_2d, inp.tide_amp)).encode())
    return h.hexdigest()


def test_every_rank_makes_the_same_inputs():
    digests = ranks.spawn(_inputs_digest, 4,
                          (CELL, 2 ** 31 + 7, tiny.overrides(CELL)),
                          placement="cpu", deadline_s=120.0)
    assert len(set(digests)) == 1


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_rank_state_is_the_scattered_one_device_state(n_ranks):
    """`build_rank`'s initial state is `scatter_state` of `build`'s (no
    process group: building a rank communicates nothing)."""
    case, traffic, _, dtype = harness.load(CELL, tiny.overrides(CELL))
    inp = inputs.make_inputs(case, traffic, 29, tiny.CPU)
    one = sides.build(sides.port_modules(), inp, dtype, tiny.CPU)
    mods = sides.rank_modules()
    from repro_torch import tree
    for rank in range(n_ranks):
        side = sides.build_rank(mods, inp, dtype, tiny.CPU, rank, n_ranks)
        want = tree.leaves(side.ranks.scatter_state(one.state))
        got = tree.leaves(side.state)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_a_forced_configuration_is_refused_on_ranks():
    wl = next(w for w in spec.benchmark()["workloads"]
              if spec.config(w["config"]).get("forcing"))
    case, traffic, _, dtype = harness.load(
        wl["name"], tiny.overrides(wl["name"]))
    inp = inputs.make_inputs(case, traffic, 3, tiny.CPU)
    with pytest.raises(ValueError, match="forcing"):
        sides.build_rank(sides.rank_modules(), inp, dtype, tiny.CPU, 0, 2)


# --- the ranks' cores ------------------------------------------------------

def test_cpu_blocks_split_the_cpus_evenly():
    assert ranks.cpu_blocks(range(32), 4) == [list(range(8 * r, 8 * r + 8))
                                              for r in range(4)]
    # unsorted CPUs are sorted; one left over stays unbound
    assert ranks.cpu_blocks([4, 0, 3, 1, 2], 2) == [[0, 1], [2, 3]]
    assert ranks.cpu_blocks(range(3), 4) == []


def _bound_cpus(rank, n_ranks, device, marks):
    ranks._bind(rank, n_ranks)
    return sorted(os.sched_getaffinity(0))


def test_each_rank_binds_to_its_own_block():
    cpus = sorted(os.sched_getaffinity(0))
    got = ranks.spawn(_bound_cpus, 2, placement="cpu", deadline_s=120.0)
    if len(cpus) < 2:
        assert got == [cpus, cpus]
    else:
        assert got == ranks.cpu_blocks(cpus, 2)
