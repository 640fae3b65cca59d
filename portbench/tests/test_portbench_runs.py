"""Whole runs of the harness on the CPU at tiny size, past its look for a
card: a sound run is correct; with the timed path broken underneath it is
not; the control is not; and nothing of JAX is loaded."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import cells, compare, harness, inputs
from portbench.run import forbidden_modules
from portbench.tests.tiny import SEED, tiny
from portbench.tests.tiny import WORKLOADS as CELLS

CPU = torch.device("cpu")
PENALISED = [w for w in CELLS
             if float(cells.find(w).traffic["recipe"].get("hyp.grad_reg.block_strength") or 0)]
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(cell, traced=False):
    start = time.perf_counter()
    return harness.run_cell(cell, SEED, 0.2, traced, CPU, lambda: time.perf_counter() - start)


def trainer_class():
    from fullbatchtraining_tpu_torch.training import training
    return training.Trainer


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result = run(tiny(workload, float64=True), traced=True)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(tiny(workload).limits)
    assert result["device"]["platform"] == "cpu"


@pytest.mark.parametrize("workload", CELLS)
def test_a_step_that_leaves_the_state_unchanged_is_caught(workload, monkeypatch):
    monkeypatch.setattr(trainer_class(), "sgd_update", lambda self, optimizer, grads, lr: None)
    result = run(tiny(workload, float64=True))
    assert not result["correct"]
    for number in ("change_gap", "change_median_gap", "grad_median_gap"):
        assert result["readings"][number]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", PENALISED)
def test_the_gradient_penalty_left_out_is_caught(workload, monkeypatch):
    from fullbatchtraining_tpu_torch.training import training
    monkeypatch.setattr(training, "make_grad_regularizer",
                        lambda cfg, grad_fn: lambda grads, *args: grads)
    cell = tiny(workload, float64=True)
    result = run(cell)
    assert not result["correct"]
    # the penalty's forward moves no running statistic and comes after the loss
    assert result["checks"]["loss0_gap"]["value"] < cell.limits["loss0_gap"]
    assert result["checks"]["stats_gap"]["value"] < cell.limits["stats_gap"]


@pytest.mark.parametrize("workload", CELLS)
def test_half_of_each_chunk_left_out_is_caught(workload, monkeypatch):
    stage = trainer_class().stage

    def half(self, step):
        images, labels = stage(self, step)
        return images[:, :self.sub // 2], labels[:, :self.sub // 2]

    monkeypatch.setattr(trainer_class(), "stage", half)
    result = run(tiny(workload, float64=True))
    assert not result["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_half_of_the_chunks_left_out_is_caught(workload, monkeypatch):
    stage = trainer_class().stage

    def half(self, step):
        images, labels = stage(self, step)
        self.num_blocks = max(1, len(images) // self.chunks // 2)
        rows = self.num_blocks * self.chunks
        return images[:rows], labels[:rows]

    monkeypatch.setattr(trainer_class(), "stage", half)
    result = run(tiny(workload, float64=True))
    assert not result["correct"]
    assert result["readings"]["chunk_gap"]["value"] == float("inf")


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The reference in the precision below the cell's (fp8 for bf16, TF32
    for float32), put in the program's place."""
    cell = tiny(workload)
    images, labels = inputs.images_and_labels(cell.config, SEED, CPU)
    weights = inputs.weights(cell.config, SEED, CPU)
    ref = compare.reference_readings(cell, images, labels, weights, SEED, 3)
    control = compare.reference_readings(cell, images, labels, weights, SEED, 3,
                                         precision=cell.traffic["control"])
    correct, checks = compare.judge(compare.gaps(control, ref), cell.limits)
    assert not correct, checks
    same, _ = compare.judge(compare.gaps(ref, ref), cell.limits)
    assert same


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fullbatchtraining_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fullbatchtraining_tpu.training", sys)
    assert forbidden_modules() == ["fullbatchtraining_tpu.training"]


def test_a_run_loads_nothing_of_jax():
    code = ("import sys, time, torch; sys.path.insert(0, %r)\n"
            "from portbench import harness\n"
            "from portbench.run import forbidden_modules\n"
            "from portbench.tests.tiny import SEED, tiny\n"
            "harness.run_cell(tiny(%r), SEED, 0.1, True,"
            " torch.device('cpu'), time.perf_counter)\n"
            "print(forbidden_modules())\n") % (ROOT, CELLS[0])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
