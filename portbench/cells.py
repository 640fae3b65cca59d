"""Find a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic (``traffic/<traffic>.json``),
the limits of its comparison (``limits/<workload>.json``), the reference of
its model family (``reference/<family>.py``, the configuration's ``model``
less its trailing digits) and the reader of each per-layer metric
(``metrics/<metric>.py``, a function ``read(ctx)``).

A later cell, configuration, model family or metric is a new file and a
new entry; none of this code names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# what every ``reference/<family>.py`` gives
FAMILY = ("architecture", "layers", "parameter_shapes", "init_std", "initial_stats", "forward",
          "tiny")


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def reported(metrics: list, workload: str) -> list:
    """The metrics of ``metrics`` that ``workload`` reports."""
    return [m for m in metrics if workload in m.get("workloads", [workload])]


def find(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(workloads)}")
    workload = workloads[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[workload["config"]]["file"])
    family(config)
    traffic = load_json(HERE / "traffic" / f"{workload['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    return Cell(workload, config, traffic, limits, reported(bench["end_to_end"], name),
                reported(bench["per_layer"], name))


def family(config: dict):
    """The reference module of ``config``'s model family:
    ``reference/<family>.py``, where ``<family>`` is its ``model`` less the
    trailing digits (``resnet152``: ``resnet``)."""
    name = str(config["model"]).rstrip("0123456789")
    path = HERE / "reference" / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        raise FileNotFoundError(f"model {config['model']!r} has no reference: "
                                f"no file {path.relative_to(ROOT)}")
    module = importlib.import_module(f"{__package__}.reference.{name}")
    missing = [f for f in FAMILY if not callable(getattr(module, f, None))]
    if missing:
        raise AttributeError(f"{path.relative_to(ROOT)} is no model family: it lacks {missing}")
    return module


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
