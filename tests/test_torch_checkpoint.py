"""The port's checkpointer (`repro_torch.checkpoint.checkpoint`), format v2:
the cases of the JAX package's `tests/test_chaos.py` (manifest,
verification, fallback, loud async failures) and
`tests/test_substrate.py::test_checkpoint_roundtrip`, and the checks
across frameworks: a campaign state that JAX writes restores bitwise in
the port and the reverse, both write the same meta.json for the same
values, and each framework's `verify` accepts the other's checkpoint and
rejects a truncated one.  CPU, float64.
"""
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.launch import sim_campaign as jcampaign  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint.checkpoint import (CheckpointCorruption,  # noqa: E402
                                               CheckpointError, Checkpointer)
from repro_torch.launch import sim_campaign  # noqa: E402
from repro_torch.runtime import chaos  # noqa: E402

F64 = torch.float64
CAMPAIGN_KEYS = ["state/.S", "state/.T", "state/.ext/.eta", "state/.ext/.qx",
                 "state/.ext/.qy", "state/.kappa_t", "state/.nu_t",
                 "state/.time", "state/.turb_eps", "state/.turb_k",
                 "state/.ux", "state/.uy", "step"]


def tree_equal(a, b) -> bool:
    la = [np.asarray(x) for x in T.leaves(a)]
    lb = [np.asarray(x) for x in T.leaves(b)]
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and np.array_equal(x, y, equal_nan=True) for x, y in zip(la, lb))


def demo_tree():
    return {"a": torch.arange(6.0, dtype=F64).reshape(2, 3),
            "b": {"c": torch.tensor(3),
                  "d": (torch.ones(4, dtype=F64), torch.zeros(2, dtype=F64))}}


# ---------------------------------------------------------------------------
# Checkpointer: manifest, verification, fallback
# ---------------------------------------------------------------------------
def test_checkpoint_manifest_written(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, demo_tree(), blocking=True)
    meta = ck.manifest(3)
    assert meta["format"] == 2 and meta["step"] == 3
    assert set(meta["leaves"]) == set(meta["keys"])
    assert meta["keys"] == ["a", "b/c", "b/d/0", "b/d/1"]
    info = meta["leaves"]["a"]
    assert info["shape"] == [2, 3] and info["dtype"] == "float64"
    assert meta["leaves"]["b/c"]["dtype"] == "int64"
    assert isinstance(info["crc32"], int)
    assert ck.verify(3) == []


def test_checkpoint_verify_detects_corruption(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, demo_tree(), blocking=True)
    d = str(tmp_path / "step_000000001")

    # bit flip -> checksum mismatch
    fn = os.path.join(d, "a.npy")
    data = bytearray(open(fn, "rb").read())
    data[-1] ^= 0xFF
    open(fn, "wb").write(bytes(data))
    assert any("checksum" in p for p in ck.verify(1))

    # truncation -> unreadable
    with open(fn, "r+b") as fh:
        fh.truncate(os.path.getsize(fn) // 2)
    assert any("unreadable" in p or "checksum" in p for p in ck.verify(1))

    # missing leaf
    os.remove(fn)
    assert any("missing" in p for p in ck.verify(1))


def test_restore_falls_back_to_newest_intact(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=5)
    t1 = demo_tree()
    t2 = T.map_leaves(lambda x: x + 1, t1)
    ck.save(1, t1, blocking=True)
    ck.save(2, t2, blocking=True)
    fn = tmp_path / "step_000000002" / "a.npy"
    with open(fn, "r+b") as fh:
        fh.truncate(4)
    assert ck.intact_steps() == [1]
    out = ck.restore(demo_tree())           # auto: falls back to step 1
    assert tree_equal(out, t1)
    with pytest.raises(CheckpointCorruption):
        ck.restore(demo_tree(), step=2)


def test_latest_step_survives_bad_pointer(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=5)
    ck.save(1, demo_tree(), blocking=True)
    ck.save(2, demo_tree(), blocking=True)
    latest = tmp_path / "latest"
    latest.write_text("step_000000999")         # dangling
    assert ck.latest_step() == 2
    latest.write_text("step_000000001")         # stale
    assert ck.latest_step() == 2
    latest.unlink()                             # missing
    assert ck.latest_step() == 2


def test_restore_latest_skips_corrupt_and_reports_step(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=5)
    t1 = demo_tree()
    ck.save(4, t1, blocking=True)
    ck.save(6, T.map_leaves(lambda x: x * 2, t1), blocking=True)
    os.remove(tmp_path / "step_000000006" / "b__c.npy")   # missing leaf
    out, step = ck.restore_latest(demo_tree())
    assert step == 4 and tree_equal(out, t1)
    ck2 = Checkpointer(str(tmp_path / "empty"))
    assert ck2.restore_latest(demo_tree()) == (None, None)


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=2)
    tree = demo_tree()
    ck.save(10, tree, blocking=True)
    ck.save(20, tree, blocking=True)
    ck.save(30, tree, blocking=True)
    assert ck.latest_step() == 30
    steps = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert len(steps) == 2                      # keep_last pruning
    out = ck.restore(tree)
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["d"][0], torch.ones(4, dtype=F64))
    assert isinstance(out["b"]["d"], tuple)


# ---------------------------------------------------------------------------
# the snapshot, devices and the template's dtype
# ---------------------------------------------------------------------------
def test_async_snapshot_is_a_copy(tmp_path, monkeypatch):
    """A CPU tensor changed in place right after an async save: the worker
    writes the values of the moment of the save (`.numpy()` would alias)."""
    ck = Checkpointer(str(tmp_path))
    real_save = np.save
    go = threading.Event()

    def slow_save(path, arr, *a, **k):
        assert go.wait(timeout=30)
        return real_save(path, arr, *a, **k)
    monkeypatch.setattr(np, "save", slow_save)
    tree = demo_tree()
    ck.save(1, tree)                            # worker waits in np.save
    tree["a"].add_(100.0)
    go.set()
    ck.wait()
    out = ck.restore(demo_tree(), step=1)
    assert torch.equal(out["a"], torch.arange(6.0, dtype=F64).reshape(2, 3))


def test_restore_onto_devices(tmp_path):
    """One device, a tree of devices, or the template leaf's own; a Python
    int leaf comes back as an int64 tensor, as JAX gives an array."""
    ck = Checkpointer(str(tmp_path))
    ck.save(2, {"x": torch.arange(12.0, dtype=F64).reshape(3, 4), "n": 7},
            blocking=True)
    tmpl = {"x": torch.zeros((3, 4), dtype=F64), "n": 0}
    for devices in (None, "cpu", torch.device("cpu"),
                    {"x": torch.device("cpu")}):
        out = ck.restore(tmpl, devices=devices)
        assert out["x"].device.type == "cpu"
        assert torch.equal(out["x"], torch.arange(12.0, dtype=F64).reshape(3, 4))
        assert out["n"].dtype == torch.int64 and int(out["n"]) == 7


def test_restore_refuses_a_template_of_another_dtype(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, demo_tree(), blocking=True)
    tmpl = demo_tree()
    tmpl["a"] = tmpl["a"].float()
    with pytest.raises(CheckpointError, match="template"):
        ck.restore(tmpl, step=1)


# ---------------------------------------------------------------------------
# async save failures must be loud
# ---------------------------------------------------------------------------
def test_async_save_failure_reraised_from_wait(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))

    def boom(*a, **k):
        raise OSError("disk full (injected)")
    monkeypatch.setattr(np, "save", boom)
    ck.save(1, demo_tree())                    # async: no error yet
    with pytest.raises(CheckpointError, match="disk full"):
        ck.wait()
    assert ck.latest_step() is None            # nothing pretends to exist


def test_async_save_failure_reraised_from_next_save(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))
    calls = {"n": 0}
    real_save = np.save

    def flaky(path, arr, *a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("quota exceeded (injected)")
        return real_save(path, arr, *a, **k)
    monkeypatch.setattr(np, "save", flaky)
    ck.save(1, demo_tree())
    with pytest.raises(CheckpointError, match="quota"):
        ck.save(2, demo_tree(), blocking=True)
    ck.save(3, demo_tree(), blocking=True)
    assert ck.latest_step() == 3 and ck.verify(3) == []


def test_chaos_io_error_site_in_worker(tmp_path):
    ck = Checkpointer(str(tmp_path))
    plan = chaos.FaultPlan([chaos.Fault("checkpoint.write", "io_error")])
    with chaos.active(plan):
        ck.save(1, demo_tree())
        with pytest.raises(CheckpointError, match="chaos"):
            ck.wait()
    assert plan.log[0]["kind"] == "io_error"
    ck.save(2, demo_tree(), blocking=True)     # disarmed: saves fine
    assert ck.latest_step() == 2


# ---------------------------------------------------------------------------
# across frameworks: the campaign state of sim_campaign.build_case
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def campaign():
    """JAX's campaign state and the same values as the port's state."""
    jcase = jcampaign.build_case(nx=4, ny=3, nl=4)
    jtree = {"state": jcase.state, "step": 3}
    st = jcase.state
    d = {k: np.asarray(getattr(st, k)) for k in
         ("ux", "uy", "T", "S", "turb_k", "turb_eps", "nu_t", "kappa_t",
          "time")}
    d["ext"] = {k: np.asarray(getattr(st.ext, k)) for k in ("eta", "qx", "qy")}
    ttree = {"state": convert.state_from_numpy(d, device="cpu"), "step": 3}
    return jtree, ttree


def _jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_leaf_names_are_jax_names(campaign):
    jtree, ttree = campaign
    jflat, _ = jckpt._flatten(jtree)
    tflat = {T.key_name(p): leaf for p, leaf in T.flatten_with_path(ttree)}
    assert list(tflat) == list(jflat)           # names AND leaf order
    assert sorted(tflat) == CAMPAIGN_KEYS


def test_jax_checkpoint_restores_bitwise_in_port(campaign, tmp_path):
    jtree, _ = campaign
    jckpt.Checkpointer(str(tmp_path)).save(3, jtree, blocking=True)
    tmpl = {"state": sim_campaign.build_case(nx=4, ny=3, nl=4,
                                             device="cpu").state, "step": 0}
    ck = Checkpointer(str(tmp_path))
    assert ck.verify(3) == []
    out = ck.restore(tmpl)
    got = [x.numpy() for x in T.leaves(out)]
    want = _jax_leaves(jtree)
    assert len(got) == len(want) == 13
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert int(out["step"]) == 3


def test_port_checkpoint_restores_bitwise_in_jax(campaign, tmp_path):
    jtree, _ = campaign
    tcase = sim_campaign.build_case(nx=4, ny=3, nl=4, device="cpu")
    st = T.map_leaves(lambda x: x + 0.25, tcase.state)  # not JAX's values
    Checkpointer(str(tmp_path)).save(5, {"state": st, "step": 5},
                                     blocking=True)
    jck = jckpt.Checkpointer(str(tmp_path))
    assert jck.verify(5) == []
    out = jck.restore(jtree)
    got = _jax_leaves(out)
    want = [x.numpy() for x in T.leaves({"state": st, "step": torch.tensor(5)})]
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_both_write_the_same_manifest(campaign, tmp_path):
    jtree, ttree = campaign
    jckpt.Checkpointer(str(tmp_path / "jax")).save(3, jtree, blocking=True)
    Checkpointer(str(tmp_path / "port")).save(3, ttree, blocking=True)
    jm = json.loads((tmp_path / "jax" / "step_000000003" / "meta.json")
                    .read_text())
    tm = json.loads((tmp_path / "port" / "step_000000003" / "meta.json")
                    .read_text())
    assert jm == tm
    assert jm["keys"] == CAMPAIGN_KEYS
    assert sorted(os.listdir(tmp_path / "jax" / "step_000000003")) == \
        sorted(os.listdir(tmp_path / "port" / "step_000000003"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_verify_accepts_the_other_and_rejects_truncation(campaign,
                                                              tmp_path,
                                                              writer):
    jtree, ttree = campaign
    if writer == "jax":
        jckpt.Checkpointer(str(tmp_path)).save(3, jtree, blocking=True)
    else:
        Checkpointer(str(tmp_path)).save(3, ttree, blocking=True)
    readers = (jckpt.Checkpointer(str(tmp_path)), Checkpointer(str(tmp_path)))
    assert [r.verify(3) for r in readers] == [[], []]
    fn = tmp_path / "step_000000003" / "state__.T.npy"
    with open(fn, "r+b") as fh:
        fh.truncate(os.path.getsize(fn) // 2)
    for r in readers:
        problems = r.verify(3)
        assert problems and all("state/.T" in p for p in problems)
    with pytest.raises(CheckpointCorruption):
        Checkpointer(str(tmp_path)).restore(ttree, step=3)
    with pytest.raises(jckpt.CheckpointCorruption):
        jckpt.Checkpointer(str(tmp_path)).restore(jtree, step=3)
