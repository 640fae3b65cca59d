"""Epochs and validation sets streamed from the host, and evaluation in
sub-chunks.

* ``stream_plan``, ``_resolve_eval_chunking`` and the activation estimate
  equal the JAX package's over a grid of inputs.
* The port's streamed ``train()`` (``impl.hbm_epoch_max_bytes`` forced
  below the epoch and the validation set) is bitwise its resident
  ``train()`` on the CPU, for ``fb1``, ``gradreg`` with the ``acc_strength``
  pre-pass, the stochastic baseline, SAM, a shuffled epoch, the
  semi-stochastic rounds of a baked store and ImageNet's transforms: the
  passes walk the same rows in the same order with the same draws.
* Evaluation in sub-chunks (``impl.eval_block_chunks``) agrees with
  evaluation in whole blocks to 1e-12 in float64: it changes the order of
  summation only.
* One JAX streamed ``train()`` against the port's: shuffled ``fb1`` on
  TinyImageNet-shaped data (64x64, 200 classes), ResNet-18 at width 4 in
  float64 from the same weights, unaugmented, 2 steps, rtol 1e-8 as the
  other ``train()`` parity tests.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fullbatchtraining_tpu.models.models as jax_models
from fullbatchtraining_tpu.config import load_config as jax_load_config
from fullbatchtraining_tpu.data import construct_databundle as jax_databundle
from fullbatchtraining_tpu.data.pipeline import stream_plan as jax_stream_plan
from fullbatchtraining_tpu.parallel import make_mesh
from fullbatchtraining_tpu.training.training import _resolve_eval_chunking as jax_eval_chunking
from fullbatchtraining_tpu.training.training import train as jax_train
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.convert import export_jax_variables, load_jax_variables
from fullbatchtraining_tpu_torch.data import construct_databundle, stream_plan
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.models.models import estimate_activation_bytes
from fullbatchtraining_tpu_torch.parallel import streaming
from fullbatchtraining_tpu_torch.parallel.streaming import HostRows, stream_segments
from fullbatchtraining_tpu_torch.training import TrainState, Trainer, make_optimizer, train
from fullbatchtraining_tpu_torch.training.training import _resolve_eval_chunking, stage_validation

RTOL = 1e-8


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the runs here are many tiny ops, which several
    test workers with a thread per core each slow down some tenfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_stream_plan_matches_jax():
    for blocks, chunks, sub, devices, item, budget, seg in itertools.product(
            (1, 3, 48), (1, 2), (8, 128), (1, 2), (3072, 12288), (1, 40_000, 1 << 20, 8 << 30),
            (0, 2, 100)):
        impl = {"hbm_epoch_max_bytes": budget, "stream_segment_blocks": seg}
        assert stream_plan(blocks, chunks, sub, devices, item, impl) == jax_stream_plan(
            blocks, chunks, sub, devices, item, impl)
    assert jax_stream_plan(3, 1, 8, 1, 8, {}) == stream_plan(3, 1, 8, 1, 8, {})  # defaults


def test_eval_chunking_matches_jax():
    specs = ("auto", True, False, None, 0, 1, 2, 3, 5, 7, 128, 1000)
    for spec, batch, act, budget, double in itertools.product(
            specs, (1, 12, 128, 2048), (None, 0, 3_000, 1_500_000), (None, 1 << 20, 9 << 30),
            (False, True)):
        assert (_resolve_eval_chunking(spec, batch, act, budget, double)
                == jax_eval_chunking(spec, batch, act, budget, double)), (spec, batch, act)


@pytest.mark.parametrize("model,pixels", [("resnet18", 32), ("resnet18", 224), ("resnet50", 64)],
                         ids=str)
def test_activation_estimate_matches_jax(model, pixels, config_dir):
    """The forward hooks on the meta device count what the JAX package's
    abstract trace counts, in bf16 and float32."""
    overrides = [f"model={model}", "model.width=4"]
    jmodel = jax_models.construct_model(jax_load_config(config_dir, overrides=overrides).model,
                                        3, 200)
    tmodel = construct_model(load_config(config_dir, overrides=overrides).model, 3, 200)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    for jdtype, dtype in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        assert (estimate_activation_bytes(tmodel, pixels, 3, dtype)
                == jax_models.estimate_activation_bytes(jmodel, pixels, 3, jdtype))
    assert all(torch.equal(v, before[k]) for k, v in tmodel.state_dict().items())


def test_host_rows_on_the_cpu_are_views_or_gathers():
    """On the CPU a segment of consecutive rows is a view of the host
    array, and other rows are its gather; segments cover every row once."""
    source = np.arange(10 * 2 * 3, dtype=np.uint8).reshape(10, 2, 3)
    rows = HostRows(source, None, 5, 2, 2)
    segments = list(stream_segments(rows, "cpu"))
    assert [s for s, _ in segments] == [0, 2, 4] and [len(t) for _, t in segments] == [2, 2, 1]
    base = source.__array_interface__["data"][0]
    assert [t.data_ptr() - base for _, t in segments] == [0, 4 * 6, 8 * 6]
    order = np.array([9, 8, 3, 4, 5, 6, 0, 1])
    rows = HostRows(source, order, 4, 2, 3)
    (_, first), (_, second) = stream_segments(rows, "cpu")
    np.testing.assert_array_equal(first.numpy().reshape(6, 2, 3), source[order[:6]])
    np.testing.assert_array_equal(second.numpy().reshape(2, 2, 3), source[order[6:]])
    assert second.data_ptr() == base + 0   # rows 0 and 1: consecutive, a view again


SMALL = ["model=resnet18", "model.width=4", "data.path=/tmp/__torch_nodata__", "data.size=64",
         "data.batch_size=16", "hyp.sub_batch=8", "hyp.steps=2", "hyp.warmup=0",
         "impl.validate_every_nth_step=1", "seed=0", "name=streamed"]
# 40,000 bytes: every block of 16 CIFAR images (49,152 bytes) is a segment,
# and the validation set's one block streams too
STREAMED = ["impl.hbm_epoch_max_bytes=40000"]
CASES = {
    "fb1": ["hyp=fb1"],
    "gradreg-acc": ["hyp=gradreg", "hyp.grad_reg.acc_strength=0.5", "hyp.shuffle=True",
                    "data.size=32"],
    "stochastic": ["hyp=base_sgd"],
    "sam": ["hyp=fb1", "hyp/optim_modification=SAM"],
    # segments of 3 blocks: 3, then 1
    "shuffled": ["hyp=fb1", "hyp.shuffle=True", "impl.stream_segment_blocks=3"],
    "semi": ["hyp=base_sgd", "hyp.train_semi_stochastic=True", "data/db=baked",
             "data.db.rounds=2", "data.augmentations_train="],
    # RandomResizedCrop 224 and flips of 32 images, Resize 256 and CenterCrop
    # 224 of 16: a block of 8 (1.2 MB) a segment under a budget of 1 MB
    "imagenet": ["hyp=fb1", "data=ImageNet", "data.size=32", "data.batch_size=8"],
}


def _port_run(overrides, config_dir):
    cfg = load_config(config_dir, overrides=overrides)
    bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0, device="cpu")
    if cfg.data.name == "ImageNet":   # 1,000 images at 224 px: keep 16 of them
        bundle.valid = bundle.valid.subset(np.arange(16))
    model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=0)
    streaming.reset_counts()
    state, stats = train(model, bundle, cfg, device="cpu")
    stats.pop("train_time")
    return state.model.state_dict(), dict(stats), dict(streaming.counts)


@pytest.mark.parametrize("case", list(CASES))
def test_streamed_train_is_bitwise_the_resident_train(case, config_dir, tmp_path):
    overrides = SMALL + CASES[case]
    if "data/db=baked" in overrides:
        overrides.append(f"data.db.path={tmp_path / 'db'}")
    ref, ref_stats, none = _port_run(overrides, config_dir)
    budget = ["impl.hbm_epoch_max_bytes=1000000"] if case == "imagenet" else STREAMED
    ours, stats, counts = _port_run(overrides + budget, config_dir)
    assert none["segments"] == 0
    # two steps and two evaluations (three passes a SAM step, two an
    # acc_strength step), several segments each
    assert counts["segments"] >= 2 * 3, counts
    assert [k for k in ref if not torch.equal(ours[k], ref[k])] == []
    assert stats == ref_stats


def test_chunked_evaluation_matches_whole_blocks(config_dir):
    """Blocks of 16 in 4 sub-chunks, test-time flips on, float64: the sums
    agree with whole-block sums to 1e-12; streamed from the host, the same."""
    base = SMALL + ["hyp=fb1", "impl.dtype=float64", "impl.accumulation_dtype=float64",
                    "hyp.test_time_flips=True", "data.size=160"]
    results = []
    for extra in (["impl.eval_block_chunks=1"], ["impl.eval_block_chunks=4"],
                  ["impl.eval_block_chunks=3", "impl.hbm_epoch_max_bytes=40000"]):
        cfg = load_config(config_dir, overrides=base + extra)
        bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0, device="cpu")
        model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=0)
        trainer = Trainer(model, bundle, cfg, torch.device("cpu"))
        state = TrainState(step=0, model=model, optimizer=make_optimizer(model, cfg.hyp))
        trainer.full_step(state, *trainer.stage(0))   # running stats away from their init
        val = stage_validation(bundle, bundle.batch_size, "cpu", cfg_impl=cfg.impl)
        assert isinstance(val[0], HostRows) == ("impl.hbm_epoch_max_bytes=40000" in extra)
        results.append((trainer.eval_chunks, {k: v.item() for k, v in
                                              trainer.eval_step(model, *val).items()}))
    (one, whole), (four, chunked), (streamed_chunks, streamed) = results
    assert (one, four, streamed_chunks) == (1, 4, 4)   # 3 rounds up to a divisor of 16
    assert len(bundle.valid) == 32 and 0 < whole["valid_acc"] < 1
    for key, value in whole.items():
        assert abs(chunked[key] - value) <= 1e-12 * abs(value), key
        assert abs(streamed[key] - value) <= 1e-12 * abs(value), key


JAX_BASE = [
    "model=resnet18", "model.width=4", "hyp=fb1", "data=TinyImageNet", "data.size=32",
    "data.path=/tmp/__torch_nodata__", "data.batch_size=16", "hyp.sub_batch=8",
    "hyp.steps=2", "hyp.warmup=1", "impl.validate_every_nth_step=1", "hyp.shuffle=True",
    "data.augmentations_train=", "impl.dtype=float64", "impl.accumulation_dtype=float64",
    "impl.mixed_precision=False", "impl.block_grouping=1", "impl.eval_block_chunks=1",
    # an epoch of 32 images of 64x64 is 393,216 bytes, the padded validation
    # set of 200 is 13 blocks of 196,608: both stream a block a segment
    "impl.hbm_epoch_max_bytes=300000", "seed=0", "name=torch_streamed_parity",
]


def _assert_trees_close(ours, ref, path=""):
    assert set(ours) == set(ref), (path, set(ours) ^ set(ref))
    for key in ref:
        if isinstance(ref[key], dict):
            _assert_trees_close(ours[key], ref[key], f"{path}/{key}")
        else:
            np.testing.assert_allclose(ours[key], np.asarray(ref[key]), rtol=RTOL, atol=1e-12,
                                       err_msg=f"{path}/{key}")


def test_streamed_train_matches_jax(config_dir, monkeypatch):
    with jax.enable_x64(True):
        cfg = jax_load_config(config_dir, overrides=JAX_BASE)
        mesh = make_mesh(cfg.impl.setup, devices=np.asarray(jax.devices()[:1]))
        bundle = jax_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
        model = jax_models.construct_model(cfg.model, bundle.channels, bundle.classes)
        # float64 variables for the JAX train(), as in tests/test_torch_training.py
        variables = jax.device_get(jax_models.initialize_model(
            model, jax.random.key(cfg.seed), bundle.pixels, bundle.channels,
            dtype=jnp.float64))
        monkeypatch.setattr(jax_models, "initialize_model", lambda *a, **k: variables)
        state, ref_stats = jax_train(model, bundle, mesh, cfg)
        ref_params = jax.device_get(state.params)
        ref_bn = jax.device_get(state.batch_stats)

    tcfg = load_config(config_dir, overrides=JAX_BASE)
    tbundle = construct_databundle(tcfg.data, tcfg.impl, tcfg.hyp, seed=0)
    np.testing.assert_array_equal(tbundle.train.images, bundle.train.images)
    assert tbundle.train.images.shape == (32, 64, 64, 3) and tbundle.classes == 200
    tmodel = construct_model(tcfg.model, tbundle.channels, tbundle.classes).to(torch.float64)
    load_jax_variables(tmodel, variables)
    streaming.reset_counts()
    tstate, stats = train(tmodel, tbundle, tcfg, device="cpu")
    # per step: 2 training segments, 13 validation segments
    assert streaming.counts["segments"] == 2 * (2 + 13), streaming.counts

    assert tstate.step == 2
    ours = export_jax_variables(tmodel)
    _assert_trees_close(ours["params"], ref_params, "params")
    _assert_trees_close(ours["batch_stats"], ref_bn, "batch_stats")
    keys = set(ref_stats) - {"train_time"}
    assert keys == set(stats) - {"train_time"}
    for key in sorted(keys):
        np.testing.assert_allclose(stats[key], ref_stats[key], rtol=RTOL, atol=1e-12,
                                   err_msg=key)
