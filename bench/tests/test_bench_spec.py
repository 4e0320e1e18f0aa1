"""BENCHMARK.json against the contract's shape, and every file it names
found by name under bench/."""
from __future__ import annotations

import re

import pytest

from bench import spec

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in B["workloads"]]


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["bench"]
    assert 1 <= B["run_seconds"] <= 51


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metrics_shape(section):
    keys = {"end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[section]
    e2e = {m["name"] for m in B["end_to_end"]}
    for m in B[section]:
        assert set(m) - {"workloads"} == keys, m["name"]
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if section == "end_to_end":
            assert 0.01 <= m["bound"] <= 0.25
            assert m["source"] in ("host_clock", "device_trace")
        else:
            assert m["moves"] in e2e
            assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_files_found_by_name(workload):
    w = spec.workload(workload)
    assert NAME.match(w["name"]) and len(w["why"]) <= 200
    assert w["chips"] in (1, 4)
    case = spec.config(w["config"])
    traffic = spec.traffic(w["traffic"])
    cell = spec.cell(workload)
    assert case["dtype"] == "float64"
    assert {"nl", "m_2d"} <= set(traffic)
    assert set(cell["limits"]) >= {"eta", "ux", "uy", "T", "S"}
    assert cell["flops_per_step"] > 0
    for section in ("end_to_end", "per_layer"):
        for m in spec.metrics_of(workload, section):
            if section == "per_layer":
                assert callable(spec.reader(m["name"]))


def test_few_cells_take_four_chips():
    """At most a quarter of the cells, rounded down, take four chips, and
    always one may."""
    four = [w for w in B["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(B["workloads"]) // 4)


@pytest.mark.parametrize("config", [c["name"] for c in B["configs"]])
def test_config_files(config):
    c = next(c for c in B["configs"] if c["name"] == config)
    assert c["file"] == f"bench/configs/{config}.json"
    assert set(c["reduced"]) <= set(spec.config(config))
    assert len(c["source"]) <= 200 and len(c["why"]) <= 200


def test_missing_files_are_named():
    with pytest.raises(FileNotFoundError, match="no-such"):
        spec.cell("no-such")
    with pytest.raises(KeyError):
        spec.workload("no-such")
