"""``--multirun`` sweeps in the port against the JAX package's
(``config.expand_multirun``, ``utils.hydra_main``, ``utils.job_startup``).

The expansion of every argv case of ``tests/test_multirun.py`` must equal
the JAX package's exactly, and so must the jobs the two launchers start, in
order, with their numbers and their ``[multirun]`` lines. Job ``i`` runs in
``<hydra.sweep.dir>/<i>``; under ``impl/setup=distributed`` every rank takes
rank 0's sweep time. A CLI sweep on the CPU makes ``<sweep>/0`` and
``<sweep>/1``, each with its log.
"""

import datetime
import os
import pathlib
import socket
import subprocess
import sys

import pytest

from fullbatchtraining_tpu.config import expand_multirun as jax_expand_multirun
from fullbatchtraining_tpu.utils import hydra_main as jax_hydra_main
from fullbatchtraining_tpu_torch.config import expand_multirun, load_config
from fullbatchtraining_tpu_torch.parallel import World
from fullbatchtraining_tpu_torch.utils import _shared_stamp, hydra_main, job_startup

ROOT = pathlib.Path(__file__).resolve().parent.parent

ARGV = {
    "no-flag": ["a=1,2", "b=x"],
    "cartesian": ["--multirun", "db=mysql,postgres", "schema=a,b,c"],
    "short-flag": ["-m", "hyp=fb1,gradreg", "seed=0"],
    "brackets-and-quotes": ["-m", "key=[a,b],[c,d]", "q='x,y'"],
    "deletion": ["-m", "~hyp.warmup", "seed=0,1"],
    "nested-and-empty": ["--multirun", "a=(1,2),3", "b=", "+c={x:1,y:2},z"],
}


@pytest.mark.parametrize("case", list(ARGV))
def test_expand_multirun_matches_jax(case):
    assert expand_multirun(ARGV[case]) == jax_expand_multirun(ARGV[case])


@pytest.mark.parametrize("case", list(ARGV))
def test_launcher_starts_the_jax_jobs(case, tmp_path, monkeypatch, capsys):
    """Both launchers call the job with the same overrides and numbers, from
    the directory the sweep started in, under one stamp, and print the same
    lines. A sweep returns to that directory after each job; a single run
    stays where its job went, in both packages."""
    (tmp_path / "elsewhere").mkdir()
    runs = []
    for launcher in (hydra_main, jax_hydra_main):
        monkeypatch.chdir(tmp_path)
        calls = []

        def job(overrides, job_num=None, sweep_stamp=None, calls=calls):
            calls.append((list(overrides), job_num, os.getcwd(), sweep_stamp))
            os.chdir(tmp_path / "elsewhere")   # the launcher restores the launch directory
            return job_num

        result = launcher(job, argv=ARGV[case])
        assert pathlib.Path.cwd() == tmp_path / ("elsewhere" if case == "no-flag" else "")
        assert len({c[3] for c in calls}) == 1
        runs.append((result, [c[:3] for c in calls], capsys.readouterr().out))
    assert runs[0] == runs[1]


def test_a_failing_job_ends_the_sweep(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    calls = []

    def job(overrides, job_num=None, sweep_stamp=None):
        calls.append(job_num)
        raise RuntimeError(f"job {job_num} failed")

    with pytest.raises(RuntimeError, match="job 0 failed"):
        hydra_main(job, argv=["-m", "seed=0,1,2"])
    assert calls == [0] and pathlib.Path.cwd() == tmp_path


def test_sweep_dir_layout(tmp_path, monkeypatch, config_dir):
    """Job ``i`` of a sweep runs in ``<hydra.sweep.dir>/<i>``, the sweep's
    ``${now:...}`` read at its stamp; a single run in ``hydra.run.dir``."""
    monkeypatch.chdir(tmp_path)
    stamp = datetime.datetime(2026, 1, 2, 3, 4, 5, 678901)
    cfg = load_config(config_dir,
                      overrides=["seed=0", "hydra.sweep.dir=sweep/${now:%H-%M-%S.%f}"])
    job_startup(cfg, "t", job_num=3, sweep_stamp=stamp)
    assert pathlib.Path.cwd() == (tmp_path / "sweep" / "03-04-05.678901" / "3").resolve()
    assert (pathlib.Path.cwd() / "t.log").exists()
    monkeypatch.chdir(tmp_path)
    cfg = load_config(config_dir, overrides=["seed=0", f"base_dir={tmp_path / 'out'}"])
    job_startup(cfg, "t", job_num=0, sweep_stamp=stamp)
    assert pathlib.Path.cwd() == tmp_path / "out" / "2026-01-02" / "03-04-05.678901" / "0"
    monkeypatch.chdir(tmp_path)
    cfg = load_config(config_dir, overrides=["seed=0", "hydra.run.dir=single"])
    job_startup(cfg, "t", sweep_stamp=stamp)
    assert pathlib.Path.cwd() == (tmp_path / "single").resolve()


def test_shared_stamp_keeps_the_microsecond():
    stamp = datetime.datetime(2026, 10, 17, 23, 59, 59, 999999)
    assert _shared_stamp(World(), stamp) == stamp


RANK_SCRIPT = """
import datetime, os, sys
import torch.distributed as dist
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.parallel import World
from fullbatchtraining_tpu_torch.utils import job_startup
rank, port, base = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
world = World(rank, 2, dist.group.WORLD)
# each rank's own clock: rank 1 an hour late
stamp = datetime.datetime(2026, 5, 6, 7 + rank, 8, 9, 123456)
cfg = load_config(sys.argv[4], overrides=["seed=0", f"base_dir={base}"])
job_startup(cfg, "t", world, job_num=1, sweep_stamp=stamp)
print(os.getcwd())
dist.destroy_process_group()
"""


def test_distributed_ranks_share_rank_0s_sweep(tmp_path, config_dir):
    """Two gloo ranks whose sweep stamps differ by an hour: both run job 1
    in rank 0's sweep directory, rank 1 as ``1_rank1``."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r), str(port),
                               str(tmp_path / "out"), str(config_dir)], cwd=tmp_path, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    sweep = tmp_path / "out" / "2026-05-06" / "07-08-09.123456"
    assert [o.strip().splitlines()[-1] for o in outs] == [str(sweep / "1"),
                                                         str(sweep / "1_rank1")]


def test_cli_sweep_on_the_cpu(tmp_path):
    """``python -m fullbatchtraining_tpu_torch --multirun seed=0,1`` (a tiny
    dryrun): two jobs in order, ``<sweep>/0`` and ``<sweep>/1`` of one sweep,
    each with its log and its finished run."""
    args = ["--multirun", "seed=0,1", "hyp=fb1", "model=resnet18", "model.width=4",
            "data.path=/tmp/__torch_nodata__", "dryrun=True", "+impl.device=cpu",
            f"base_dir={tmp_path / 'out'}"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    run = subprocess.run([sys.executable, "-m", "fullbatchtraining_tpu_torch", *args], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    launched = [line for line in run.stdout.splitlines() if line.startswith("[multirun]")]
    _, jobs = expand_multirun(args)
    assert launched == [f"[multirun] launching job #{i} : {' '.join(job)}"
                        for i, job in enumerate(jobs)]
    logs = sorted((tmp_path / "out").glob("*/*/*/train_with_gradient_descent.log"))
    assert [p.parent.name for p in logs] == ["0", "1"]
    assert logs[0].parent.parent == logs[1].parent.parent
    for i, log in enumerate(logs):
        text = log.read_text()
        assert f"seed: {i}" in text and "Final validation accuracy" in text
