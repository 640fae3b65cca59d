"""Every cell, configuration, traffic, limit and metric reader is found by
name from ``BENCHMARK.json``, and the file keeps to the benchmark's rules."""

from __future__ import annotations

import re

import pytest

from portbench import cells, compare

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_is_found_with_its_parts(workload):
    cell = cells.find(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["name"] == cell.workload["traffic"]
    assert cell.limits and set(cell.limits) <= set(compare.NUMBERS)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert all(m["moves"] in e2e for m in cell.per_layer)
    for m in cell.per_layer:
        assert callable(cells.reader(m["name"]))


def test_configuration_files_are_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    assert all(f.startswith("portbench/configs/") for f in files)
    for c in BENCH["configs"]:
        assert cells.load_json(cells.ROOT / c["file"])["name"] == c["name"]


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        cells.find("no-such-cell")


def test_readers_return_nothing_without_a_trace():
    ctx = {"trace": None, "window": {"steps": 0, "seconds": 0.0},
           "work": {"images": 1, "model_flops": 1.0, "peak_flops": 1.0, "conv_min_s": 1.0,
                    "bn_min_s": 1.0}}
    for m in BENCH["per_layer"]:
        assert cells.reader(m["name"])(ctx) is None
