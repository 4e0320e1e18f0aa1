"""The external burst's CUDA graph (`core/dg2d.py` `run_external`) on the
CPU: the gate that keeps every other call on the host's loop, the key that
separates what fixes a graph's work, the bounded cache, and the counter that
says which path ran (`obs/trace.py` `count`, `counts`).  The graph itself,
bitwise against the loop, is held on the card by `tests/test_torch_gpu.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.core import dg2d  # noqa: E402
from repro_torch.core import geometry as G  # noqa: E402
from repro_torch.core import mesh2d  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

H_MIN = 0.05
PATHS = ("burst.eager", "burst.capture", "burst.replay")


class PassThrough(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def case():
    geom = G.geom2d_from_mesh(mesh2d.channel_mesh(6, 3, 3000.0, 900.0, seed=2),
                              dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(5)
    nt = geom.nt
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape))
    b = 10.0 + 10.0 * geom.node_x / 3000.0
    st0 = dg2d.State2D(0.01 * t(3, nt), 0.5 * t(3, nt), 0.5 * t(3, nt))
    return geom, b, st0, 1e-3 * t(3, nt), 1e-3 * t(3, nt)


def _paths():
    c = trace.counts()
    return tuple(c.get(k, 0) for k in PATHS)


def _delta(before):
    return tuple(a - b for a, b in zip(_paths(), before))


def _card(monkeypatch):
    """Let the gate take CPU tensors for card tensors with no capture
    running, so that only the condition under test can refuse it."""
    monkeypatch.setattr(dg2d, "_card_tensors", lambda ts: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)


def _equal(a, b):
    fa = (*a.state.__dict__.values(), *a[1:])
    fb = (*b.state.__dict__.values(), *b[1:])
    return all(torch.equal(x, y) for x, y in zip(fa, fb))


def test_counter_counts_by_name():
    before = trace.counts()
    trace.count("test.counter")
    trace.count("test.counter")
    after = trace.counts()
    assert after["test.counter"] - before.get("test.counter", 0) == 2
    after["test.counter"] = -1            # a copy: the counter is unchanged
    assert trace.counts()["test.counter"] >= 2


@pytest.mark.parametrize("refuse", ["control", "cpu", "exchange_fn",
                                    "dispatch_mode", "capturing",
                                    "requires_grad"])
def test_gate(case, monkeypatch, refuse):
    geom, b, st0, f3x, _ = case
    exchange = None
    if refuse != "cpu":
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: refuse == "capturing")
        monkeypatch.setattr(dg2d, "_card_tensors",
                            lambda ts: not any(t.requires_grad for t in ts))
    if refuse == "exchange_fn":
        exchange = lambda s: s
    if refuse == "requires_grad":
        f3x = f3x.clone().requires_grad_(True)
    if refuse == "dispatch_mode":
        with PassThrough():
            ok = dg2d._graphable(st0, b, f3x, exchange)
    else:
        ok = dg2d._graphable(st0, b, f3x, exchange)
    assert ok == (refuse == "control")


@pytest.mark.parametrize("path", ["cpu", "exchange_fn", "dispatch_mode"])
def test_refused_burst_runs_the_loop_and_counts_eager(case, monkeypatch,
                                                       path):
    geom, b, st0, f3x, f3y = case
    exchange = None
    if path != "cpu":
        _card(monkeypatch)     # a wrong gate would try to capture, and fail
    if path == "exchange_fn":
        exchange = lambda s: s
    before = _paths()
    if path == "dispatch_mode":
        with PassThrough():
            out = dg2d.run_external(geom, b, st0, 20.0, 4, dg2d.Forcing2D(),
                                    f3x, f3y, h_min=H_MIN)
    else:
        out = dg2d.run_external(geom, b, st0, 20.0, 4, dg2d.Forcing2D(),
                                f3x, f3y, h_min=H_MIN, exchange_fn=exchange)
    assert _delta(before) == (1, 0, 0)
    ref = dg2d._run_eager(geom, b, st0, 20.0, 4, dg2d.Forcing2D(), f3x, f3y,
                          0.0, 0.0, H_MIN)
    assert _equal(out, ref)


def test_cpu_bursts_of_one_key_stay_eager(case):
    geom, b, st0, f3x, f3y = case
    before = _paths()
    for _ in range(3):
        dg2d.run_external(geom, b, st0, 20.0, 2, dg2d.Forcing2D(), f3x, f3y,
                          h_min=H_MIN)
    assert _delta(before) == (3, 0, 0)


def _key(case, dt=20.0, m=4, forcing=None, f3d=True, coriolis_f=0.0,
         bottom_cd=0.0, h_min=H_MIN, b=None, st0=None):
    geom, b0, st00, f3x, f3y = case
    forcing = forcing or dg2d.Forcing2D()
    ins = dg2d._inputs(st0 or st00, forcing, f3x if f3d else None,
                       f3y if f3d else None)
    return dg2d._key(geom, b0 if b is None else b, ins, dt, m, coriolis_f,
                     bottom_cd, h_min)


@pytest.mark.parametrize("change", ["dtau", "m", "eta_open", "tau",
                                    "f3d2d", "h_min", "coriolis_f",
                                    "bottom_cd", "b"])
def test_key_separates(case, change):
    geom, b, st0, f3x, _ = case
    ones = torch.ones_like(st0.eta)
    other = {"dtau": dict(dt=10.0), "m": dict(m=2),
             "eta_open": dict(forcing=dg2d.Forcing2D(eta_open=ones)),
             "tau": dict(forcing=dg2d.Forcing2D(tau_x=ones, tau_y=ones)),
             "f3d2d": dict(f3d=False), "h_min": dict(h_min=0.1),
             "coriolis_f": dict(coriolis_f=1e-4),
             "bottom_cd": dict(bottom_cd=2.5e-3), "b": dict(b=b.clone())}
    assert _key(case) != _key(case, **other[change])
    # the scalars apart, what the graph reads and copies in is shared
    same_io = change in ("dtau", "m", "h_min", "coriolis_f", "bottom_cd")
    assert (_key(case)[0] == _key(case, **other[change])[0]) == same_io


def test_key_holds_across_new_values(case):
    _, _, st0, _, _ = case
    fresh = dg2d.State2D(st0.eta + 1.0, st0.qx * 2.0, st0.qy.clone())
    eta_bc = torch.ones_like(st0.eta)
    assert _key(case, st0=fresh) == _key(case)
    assert (_key(case, forcing=dg2d.Forcing2D(eta_open=eta_bc))
            == _key(case, forcing=dg2d.Forcing2D(eta_open=2.0 * eta_bc)))


def test_cache_drops_the_least_recently_used():
    cache = dg2d._BurstGraphs(2)
    a, b, c = cache.entry("a"), cache.entry("b"), cache.entry("c")
    assert list(cache.entries) == ["b", "c"]
    assert cache.entry("b") is b and list(cache.entries) == ["c", "b"]
    cache.entry("a")
    assert list(cache.entries) == ["b", "a"] and cache.entry("a") is not a
    assert c not in cache.entries.values()


def test_cache_shares_inputs_by_reads_and_shapes():
    cache = dg2d._BurstGraphs(4)
    first = cache.entry((("io",), (10.0, 2)))
    second = cache.entry((("io",), (20.0, 4)))
    assert cache.inputs_of(("io",)) is None       # nothing captured yet
    first.inputs = {"eta": torch.zeros(3)}
    assert cache.inputs_of(("io",)) is first.inputs
    assert cache.inputs_of(("other",)) is None
    assert second.inputs is None
