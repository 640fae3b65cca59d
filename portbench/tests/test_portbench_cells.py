"""Every cell, configuration, traffic, limit and metric reader is found by
name from ``BENCHMARK.json``, and the file keeps to the benchmark's rules."""

from __future__ import annotations

import copy
import json
import os
import re
import shutil
import subprocess
import sys

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


def test_the_family_is_found_by_the_model_less_its_digits():
    for workload in WORKLOADS:
        config = cells.find(workload).config
        family = cells.family(config)
        assert family.__name__ == "portbench.reference." + config["model"].rstrip("0123456789")
        assert all(callable(getattr(family, f)) for f in cells.FAMILY)


def test_a_model_with_no_reference_is_refused_when_the_cell_is_found(tmp_path):
    bench = copy.deepcopy(BENCH)
    workload = bench["workloads"][0]
    entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
    config = dict(cells.load_json(cells.ROOT / entry["file"]), model="nosuchnet50")
    entry["file"] = "nosuchnet50.json"
    (tmp_path / "nosuchnet50.json").write_text(json.dumps(config))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(FileNotFoundError, match="portbench/reference/nosuchnet.py"):
        cells.find(workload["name"], root=tmp_path)


PLAINNET = '''"""A plain net: a 3x3 convolution, BatchNorm, ReLU, global pool, linear."""

import torch.nn.functional as F

from . import layers as common
from .layers import init_std  # noqa: F401


def architecture(config):
    c, h = int(config["model.width"]), int(config["data.pixels"])
    return [("conv", "conv", int(config["data.channels"]), c, 3, 1, h), ("bn", "bn", c, h),
            ("fc", "fc", c, int(config["data.classes"]))]


def layers(plan):
    yield from plan


def parameter_shapes(plan):
    return common.parameter_shapes(plan)


def initial_stats(plan, device):
    return common.initial_stats(plan, device)


def forward(plan, params, stats, x, update_stats=True, conv=None, linear=None, act=None,
            norm=None):
    f = common.Functions(conv, linear, act, norm)
    x = f.conv(x, params["conv.weight"], 1, 1)
    x = F.relu(f.act(f.norm(x, params["bn.weight"], params["bn.bias"], stats, "bn",
                            update_stats)))
    return f.linear(f.act(x.mean(dim=(2, 3))), params["fc.weight"], params["fc.bias"])


def tiny(config):
    return dict(config, **{"model.width": 4})
'''

FAMILY_RUN = '''
import json, sys, torch
sys.path.insert(0, ".")
from portbench import cells, compare, inputs, work
from portbench.tests.tiny import SEED, tiny
cell = tiny("plainnet3-cifar10.gradreg-c512", float64=True)
cpu = torch.device("cpu")
images, labels = inputs.images_and_labels(cell.config, SEED, cpu)
weights = inputs.weights(cell.config, SEED, cpu)
ref = compare.reference_readings(cell, images, labels, weights, SEED, 2)
print(json.dumps({"family": cells.family(cell.config).__file__,
                  "work": work.step_work(cell.config, cell.traffic["recipe"]),
                  "weights": {k: list(v.shape) for k, v in weights.items()},
                  "loss": ref["loss"], "change": ref["change"]}))
'''


def test_a_family_is_added_by_new_files_alone(tmp_path):
    """A copy of the benchmark takes a new family, ``plainnet``, from one
    new module under ``reference/``, a configuration, a limits file and
    two entries of ``BENCHMARK.json``; no file of the benchmark changes.
    Its cell is found, cut, counted, drawn and run by the reference."""
    shutil.copytree(cells.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    pb = tmp_path / "portbench"
    (pb / "reference" / "plainnet.py").write_text(PLAINNET)
    base = cells.find(WORKLOADS[0]).config
    config = {"name": "plainnet3-cifar10", "model": "plainnet3", "data": "CIFAR10",
              "model.width": 16, **{k: v for k, v in base.items() if k.startswith("data.")}}
    (pb / "configs" / "plainnet3-cifar10.json").write_text(json.dumps(config))
    (pb / "limits" / "plainnet3-cifar10.gradreg-c512.json").write_text('{"loss0_gap": 1e-5}')
    bench = copy.deepcopy(BENCH)
    bench["configs"].append({"name": "plainnet3-cifar10", "source": "a test",
                             "file": "portbench/configs/plainnet3-cifar10.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "plainnet3-cifar10.gradreg-c512",
                               "config": "plainnet3-cifar10", "traffic": "gradreg-c512",
                               "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", FAMILY_RUN], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["family"] == str(pb / "reference" / "plainnet.py")
    assert got["weights"] == {"conv.weight": [4, 3, 3, 3], "bn.weight": [4], "bn.bias": [4],
                              "fc.weight": [10, 4], "fc.bias": [10]}
    # 64 images, two passes; the convolution takes no input gradient
    forward = 4 * 3 * 9 * 32 * 32 + 4 * 10
    assert got["work"]["model_flops"] == 2 * 2 * 64 * (3 * forward - 4 * 3 * 9 * 32 * 32)
    assert got["work"]["bn_bytes"] == 2 * 5 * 64 * 32 * 32 * 4 * 4     # float32 counts
    assert len(got["loss"]) == 2 and all(v > 0 for v in got["change"].values())
    after = {p: p.read_bytes() for p in before}
    assert after == before
