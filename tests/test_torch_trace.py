"""``impl.trace``: a ``torch.profiler`` trace of the first ``impl.trace_steps``
steps, as the JAX package's ``jax.profiler`` hook takes it
(``fullbatchtraining_tpu/training/training.py``: started before the loop,
stopped at the top of the step after the last traced one, flushed where the
loop ends first).

On the CPU a traced run of 2 ``hyp=fb1`` steps writes
``torch_trace/rank0.json`` in the working directory, a Chrome trace that
holds the traced steps' convolutions and the program's ``fbt.chunk``
spans (4 chunks a step): one step's with ``trace_steps=1``, both steps'
with 2. Its params, running stats and stats are bitwise those
of the untraced run (which ``tests/test_torch_training.py`` holds against
the JAX ``train()``). A dryrun stops the loop before ``trace_steps``, and
the trace is written all the same; so through the CLI.
"""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.data import construct_databundle
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.tracing import CHUNK
from fullbatchtraining_tpu_torch.training import train

from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
BASE = ["model=resnet18", "model.width=4", "hyp=fb1", "data.size=32",
        "data.path=/tmp/__torch_nodata__", "data.batch_size=16", "hyp.sub_batch=8",
        "hyp.steps=2", "hyp.warmup=0", "impl.validate_every_nth_step=1", "seed=0"]
TRACE = "torch_trace/rank0.json"
CHUNKS = 4   # 2 blocks of 16 in chunks of 8


def _run(config_dir, extra):
    cfg = load_config(config_dir, overrides=BASE + extra)
    bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
    model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=0)
    state, stats = train(model, bundle, cfg, device="cpu")
    return state.model.state_dict(), stats


def _count(file: pathlib.Path, name: str) -> int:
    events = json.loads(file.read_text())["traceEvents"]
    return sum(e.get("name") == name for e in events)


def _convolutions(file: pathlib.Path) -> int:
    return _count(file, "aten::conv2d")


def test_trace_covers_its_steps_and_changes_nothing(config_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ref, ref_stats = _run(config_dir, [])
    assert not (tmp_path / "torch_trace").exists()
    counts, chunks = {}, {}
    for steps in (1, 2):
        run = tmp_path / str(steps)
        run.mkdir()
        monkeypatch.chdir(run)
        ours, stats = _run(config_dir, ["impl.trace=True", f"impl.trace_steps={steps}"])
        assert [k for k in ref if not torch.equal(ours[k], ref[k])] == []
        assert {k: v for k, v in stats.items() if k != "train_time"} == {
            k: v for k, v in ref_stats.items() if k != "train_time"}
        counts[steps] = _convolutions(run / TRACE)
        chunks[steps] = _count(run / TRACE, CHUNK)
    assert counts[1] > 0 and counts[2] == 2 * counts[1], counts
    assert chunks == {1: CHUNKS, 2: 2 * CHUNKS}


@pytest.mark.parametrize("how", ["train", "cli"])
def test_dryrun_flushes_the_trace(how, config_dir, tmp_path, monkeypatch):
    """A dryrun ends the loop after one step, before ``impl.trace_steps=3``:
    the trace of that step is written where the loop ends."""
    extra = ["dryrun=True", "impl.trace=True", "impl.trace_steps=3"]
    if how == "train":
        monkeypatch.chdir(tmp_path)
        _run(config_dir, extra)
        files = [tmp_path / TRACE]
    else:
        run = subprocess.run([sys.executable, "-m", "fullbatchtraining_tpu_torch", *BASE,
                              *extra, "+impl.device=cpu", f"base_dir={tmp_path}"], cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
        files = list(tmp_path.glob(f"*/*/{TRACE}"))
        assert "Wrote the torch.profiler trace" in run.stdout
    assert len(files) == 1 and _convolutions(files[0]) > 0
