"""The port's roofline (`repro_torch.roofline`) against the JAX package's.

  * `roofline_from_stats(...).to_dict()` on the TPU v5e model at the bf16
    peak equals JAX's field for field (exactly: the same float arithmetic),
    on an ocean-like record (no model flops, collective-permutes, the
    compute term from the cost analysis) and an LM-like one (model flops,
    all-reduce and all-gather bytes);
  * `model_flops_estimate` equals JAX's for the 10 architectures at full
    size and each of their shapes (the port's parameter counts, which
    `tests/test_torch_lm_model.py` holds to JAX's);
  * `rederive` is idempotent on a port record and gives JAX's `rederive`
    on a record in JAX's format; `main` walks a directory;
  * `peak_bandwidth`: the H100's HBM for ``cuda``, JAX's CPU model for
    ``cpu``, the v5e's for ``tpu``;
  * the kernels' formulas (`roofline/kernels.py`) give the bytes of
    PERF.md's kernel table at the main path's shapes (meta tensors).
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro.roofline import rederive as jrederive  # noqa: E402
from repro_torch.configs import ALL_ARCHS, SHAPES, applicable_shapes, get_arch  # noqa: E402
from repro_torch.models.model import Model, count_params  # noqa: E402
from repro_torch.roofline import analysis, rederive  # noqa: E402
from repro_torch.roofline import kernels as rk  # noqa: E402

STATS = {
    # one ocean rank: no dot flops, XLA's cost-analysis flops, halo shifts
    "ocean": dict(stats=dict(flops=0.0, bytes=3.25e9, coll_bytes=4.1e6,
                             coll_by_kind={"collective-permute": 4.1e6},
                             n_collectives=540,
                             bytes_by_source={"other": 3.0e9,
                                              "run_external": 2.5e8}),
                  chips=256, model_flops=0.0, cost_analysis_flops=7.3e9),
    # one LM rank: dot flops, model flops, all-reduce and all-gather bytes
    "lm": dict(stats=dict(flops=2.4e15, bytes=8.0e11, coll_bytes=3.2e10,
                          coll_by_kind={"all-reduce": 2.0e10,
                                        "all-gather": 1.2e10},
                          n_collectives=1210,
                          bytes_by_source={"flash_attention": 1e11}),
               chips=512, model_flops=9.1e17, cost_analysis_flops=1.0e14),
}


def _pair(stats: dict):
    return (analysis.HloStats(**{k: (dict(v) if isinstance(v, dict) else v)
                                 for k, v in stats.items()}),
            janalysis.HloStats(**{k: (dict(v) if isinstance(v, dict) else v)
                                  for k, v in stats.items()}))


@pytest.mark.parametrize("case", list(STATS))
def test_roofline_on_tpu_v5e_equals_jax(case):
    c = STATS[case]
    st, jst = _pair(c["stats"])
    got = analysis.roofline_from_stats(
        st, c["chips"], c["model_flops"], machine=analysis.TPU_V5E,
        dtype="bf16", cost_analysis_flops=c["cost_analysis_flops"])
    want = janalysis.roofline_from_stats(
        jst, c["chips"], c["model_flops"],
        cost_analysis_flops=c["cost_analysis_flops"])
    assert got.to_dict() == want.to_dict()
    assert got.dominant == want.dominant


def test_tpu_v5e_is_jax_constants_and_stats_add_as_jax():
    m = analysis.TPU_V5E
    assert (m.peak("bf16"), m.peak(torch.float32), m.hbm_bytes_per_s,
            m.link_bytes_per_s, m.collective_latency_s) == (
        janalysis.PEAK_FLOPS_BF16, janalysis.PEAK_FLOPS_F32,
        janalysis.HBM_BW, janalysis.ICI_BW, janalysis.COLL_LATENCY)
    assert analysis.SOURCE_TAGS == janalysis._SOURCE_TAGS
    st, jst = _pair(STATS["ocean"]["stats"])
    o, jo = _pair(STATS["lm"]["stats"])
    st.add(o, 3.0, include_bytes=False)
    jst.add(jo, 3.0, include_bytes=False)
    st.add_bytes(17.0, "wkv")
    jst.add_bytes(17.0, "wkv")
    assert vars(st) == vars(jst)
    with pytest.raises(KeyError):
        m.peak("f64")


def test_h100_model_and_its_dtype_peaks():
    m = analysis.H100_SXM
    assert (m.peak(torch.bfloat16), m.peak("f32"), m.peak(torch.float64),
            m.hbm_bytes_per_s) == (989e12, 67e12, 34e12, 3.35e12)
    st, _ = _pair(STATS["ocean"]["stats"])
    r = analysis.roofline_from_stats(st, 256, machine=m, dtype=torch.float32,
                                     cost_analysis_flops=7.3e9)
    assert r.compute_s == 7.3e9 / 67e12
    assert r.memory_s == 3.25e9 / 3.35e12
    assert r.collective_s == 4.1e6 / 450e9 + 540 * 7.5e-6
    assert r.dominant == "collective" and r.roofline_fraction() == 0.0


def test_peak_bandwidth_by_device_type():
    assert analysis.peak_bandwidth("cuda") == analysis.H100_SXM.hbm_bytes_per_s
    assert analysis.peak_bandwidth("cpu") == janalysis.peak_bandwidth("cpu")
    assert analysis.peak_bandwidth("tpu") == janalysis.peak_bandwidth("tpu")


@pytest.mark.parametrize("name", sorted(ALL_ARCHS))
def test_model_flops_estimate_equals_jax(name):
    arch, jarch = get_arch(name), j_get_arch(name)
    n_total, n_active = count_params(Model(arch, dtype=torch.bfloat16,
                                           device="cpu"))
    for shape in applicable_shapes(arch):
        got = analysis.model_flops_estimate(arch, SHAPES[shape], n_total,
                                            n_active)
        want = janalysis.model_flops_estimate(jarch, J_SHAPES[shape], n_total,
                                              n_active)
        assert got == want, (shape, got, want)


def _record(port: bool) -> dict:
    c = STATS["ocean"]
    rec = dict(arch="ocean-benchmark", chips=c["chips"], model_flops=0.0,
               cost_analysis=dict(flops=c["cost_analysis_flops"],
                                  bytes_accessed=1.0),
               hlo=dict(c["stats"]), roofline={"stale": True})
    if port:
        rec.update(machine="H100_SXM", dtype="f32")
    return rec


def test_rederive_is_idempotent_on_a_port_record(tmp_path):
    path = tmp_path / "single_pod" / "ocean-benchmark.json"
    path.parent.mkdir()
    path.write_text(json.dumps(_record(port=True)))
    assert rederive.main(str(tmp_path)) == 1
    once = json.loads(path.read_text())
    r = once["roofline"]
    assert r["compute_s"] == 7.3e9 / 67e12 and r["dominant"] == "collective"
    rederive.rederive(str(path))
    assert json.loads(path.read_text()) == once
    # another machine, asked for
    tpu = rederive.rederive(str(path), machine=analysis.TPU_V5E)
    assert tpu["roofline"]["memory_s"] == 3.25e9 / 819e9


def test_rederive_of_a_jax_record_is_jax_rederive(tmp_path):
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "r.json").write_text(json.dumps(_record(port=False)))
    rederive.rederive(str(tmp_path / "port" / "r.json"))
    jrederive.rederive(str(tmp_path / "jax" / "r.json"))
    assert (json.loads((tmp_path / "port" / "r.json").read_text())
            == json.loads((tmp_path / "jax" / "r.json").read_text()))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kernel_formulas_give_the_kernel_table_bytes():
    """PERF.md's kernel table, f32 at 160,000 columns by 16 layers."""
    nl, nt = 16, 160_000
    area = _meta(nt)
    assert rk.solve_r(_meta(2, nl, 6, nt), area, _meta(2, 3, nt)).bytes == 250_240_000
    assert rk.solve_w(_meta(1, nl, 6, nt), area).bytes == 123_520_000
    blk = _meta(nl, 6, 6, nt)
    k3 = rk.block_thomas(blk, blk, blk, _meta(2, nl, 6, nt))
    assert k3.bytes == 1_305_600_000
    k4 = rk.lateral_flux(_meta(4, nl, 6, nt), _meta(4, nl, 3, 2, 2, nt),
                         _meta(nl, 2, 3, 2, nt), _meta(3, nt))
    assert k4 == (1_107_840_000, 4 * nl * nt * 300)
    band = _meta(nl, nt)
    assert rk.tridiag(band, band, band, band) == (51_200_000, 8 * nl * nt)
    assert rk.soa_to_cell(_meta(nl, 6, nt)).bytes == 122_880_000
    assert rk.cell_to_soa(_meta(1250, nl * 6, 128), nt).bytes == 122_880_000
    # float64 doubles every byte and no operation
    k3d = rk.block_thomas(*(_meta(nl, 6, 6, nt, dtype=torch.float64),) * 3,
                          _meta(2, nl, 6, nt, dtype=torch.float64))
    assert k3d == (2 * k3.bytes, k3.flops)
