"""Cells, configurations, traffic, limits and metric readers are found by
name from ``BENCHMARK.json``, and the file keeps to its format's limits."""

from __future__ import annotations

import json
import re

import pytest

from portbench.harness import judge, spec

BENCH = spec.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_found_by_name(workload):
    c = spec.find_cell(workload)
    assert c.chips in (1, 4) and c.traffic["ranks"] in (1, c.chips)
    assert c.limits and set(c.limits) <= set(judge.NUMBERS)
    assert all(0 < v < 1 for v in c.limits.values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    drv, ref = c.program(), c.reference()
    assert drv.RATE_METRIC in names
    assert hasattr(drv, "Program") and hasattr(ref, "readings")
    for m in c.per_layer:
        assert m["moves"] in names, m["name"]
        assert callable(c.reader(m["name"]).read)


def test_names_units_and_bounds():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)) and all(map(NAME.match, names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(WORKLOADS)
        assert m["layer"].strip() and "\n" not in m["layer"]
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_files(config):
    c = spec.read_json(spec.ROOT / config["file"])
    assert config["file"].startswith("portbench/configs/")
    assert c["source"] == config["source"]
    assert c["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


def test_every_reader_has_its_file():
    have = {p.stem for p in (spec.BENCH_DIR / "metrics").glob("*.py")}
    assert {m["name"] for m in BENCH["per_layer"]} <= have
