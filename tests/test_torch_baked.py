"""The port's baked N x store and semi-stochastic staging against the JAX package's.

Both packages name a store alike, so each reuses what the other baked. A
policy-only store (PIL on the host, seeded alike) is byte-identical between
them; a crop/flip store draws from torch's generator, so it is checked
against its source's crop/flip windows instead. The semi-stochastic staging
of the port's resident and host paths is bitwise the rows of the JAX
``stage_epoch``. Everything here is integers and orders: every comparison is
an equality.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import fullbatchtraining_tpu_torch.data.baked as baked
from fullbatchtraining_tpu.config import load_config as jax_load_config
from fullbatchtraining_tpu.data import baked as jax_baked
from fullbatchtraining_tpu.data import construct_databundle as jax_databundle
from fullbatchtraining_tpu.data.policy_augment import apply_policy_batch as jax_apply_policy
from fullbatchtraining_tpu.models import construct_model as jax_construct_model
from fullbatchtraining_tpu.parallel import make_mesh
from fullbatchtraining_tpu.training.training import make_train_functions, stage_epoch
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.data import construct_databundle, construct_datasets
from fullbatchtraining_tpu_torch.data.policy_augment import apply_policy_batch
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.training import Trainer

ROOT = pathlib.Path(__file__).resolve().parent.parent
POLICY_ONLY = ["data.db.augmentations_train=null"]
DB_CONFIGS = {
    "crop-flip": [],
    "clean": ["data.db.first_round_clean=True"],
    "unshuffled": ["data.db.shuffle_while_writing=False"],
    "policy-mean-a": POLICY_ONLY + ["+data.db.augmentations_train.RandAugment=rand-m9-n2"],
    "policy-mean-b": POLICY_ONLY + ["+data.db.augmentations_train.RandAugment=rand-m9-n2",
                                    "data.mean=[0.5,0.4,0.3]"],
    "temporary": ["data.db.temporary_database=True"],
}
POLICY_SPECS = [("RandAugment", "rand-m7-n2-mstd0.5-inc1"), ("AutoAugment", "v0"),
                ("AugMix", "augmix-m5-w4-d2")]


def _configs(config_dir, tmp_path, extra, size=32):
    overrides = [f"data.size={size}", "data.path=/tmp/__torch_nodata__", "data/db=baked",
                 f"data.db.path={tmp_path / 'db'}", "data.db.rounds=2",
                 "data.augmentations_train=", *extra]
    return jax_load_config(config_dir, overrides=overrides), load_config(config_dir,
                                                                         overrides=overrides)


def _store_files(folder):
    return {name: (folder / name).read_bytes() for name in ("images.npy", "labels.npy",
                                                            "meta.json")}


@pytest.mark.parametrize("case", list(DB_CONFIGS))
def test_store_directory_matches_jax(case, config_dir, tmp_path):
    jcfg, cfg = _configs(config_dir, tmp_path, DB_CONFIGS[case])
    ours = baked._db_dir(cfg.data.db, cfg.data, 32, cfg.data.db.augmentations_train)
    ref = jax_baked._db_dir(jcfg.data.db, jcfg.data, 32, jcfg.data.db.augmentations_train)
    assert ours == ref
    assert ours.name.endswith(f"_tmp{os.getpid()}") == (case == "temporary")


def test_policy_geometry_and_lmdb_alias_name_the_store(config_dir, tmp_path):
    """``data.mean`` keys a policy store; ``data/db=LMDB`` names the same
    store as ``data/db=baked``."""
    dirs = {}
    for case in ("policy-mean-a", "policy-mean-b", "crop-flip"):
        cfg = _configs(config_dir, tmp_path, DB_CONFIGS[case])[1]
        dirs[case] = baked._db_dir(cfg.data.db, cfg.data, 32, cfg.data.db.augmentations_train)
    assert dirs["policy-mean-a"] != dirs["policy-mean-b"]
    lmdb = load_config(config_dir, overrides=["data/db=LMDB", f"data.db.path={tmp_path / 'db'}",
                                              "data.db.rounds=2", "data.size=32"])
    assert lmdb.data.db.name == "baked"
    assert baked._db_dir(lmdb.data.db, lmdb.data, 32,
                         lmdb.data.db.augmentations_train) == dirs["crop-flip"]


@pytest.mark.parametrize("key,spec", POLICY_SPECS)
def test_policy_batch_is_byte_identical(key, spec):
    images = np.random.default_rng(4).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    ours = apply_policy_batch(images, key, spec, (0.49, 0.48, 0.45), seed=11, img_size=32)
    ref = jax_apply_policy(images, key, spec, (0.49, 0.48, 0.45), seed=11, img_size=32)
    assert ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)
    assert not np.array_equal(ours, images)


def test_policy_bake_is_byte_identical(config_dir, tmp_path):
    """A shuffled RandAugment store baked by the port equals the JAX
    package's, file for file."""
    extra = POLICY_ONLY + ["+data.db.augmentations_train.RandAugment=rand-m7-n2-mstd0.5"]
    jcfg, _ = _configs(config_dir, tmp_path / "jax", extra)
    _, cfg = _configs(config_dir, tmp_path / "torch", extra)
    assert cfg.data.db.shuffle_while_writing
    ref = jax_databundle(jcfg.data, jcfg.impl, jcfg.hyp, seed=3).baked
    ours = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=3, device="cpu").baked
    assert ours.dir.name == ref.dir.name and ours.dir != ref.dir
    assert _store_files(ours.dir) == _store_files(ref.dir)


def _windows(image, pad=4):
    """The 162 crop/flip windows of a 32x32 image at padding 4."""
    padded = np.pad(image, ((pad, pad), (pad, pad), (0, 0)))
    size = image.shape[0]
    crops = [padded[y:y + size, x:x + size] for y in range(2 * pad + 1)
             for x in range(2 * pad + 1)]
    return np.stack(crops + [c[:, ::-1] for c in crops])


def test_crop_flip_bake_loads_in_jax(config_dir, tmp_path):
    """An unshuffled crop+flip store with a clean first round, baked by the
    port, loads in the JAX ``BakedDataset``: round 0 is the source, every
    image of round 1 is one of its source image's crop/flip windows."""
    _, cfg = _configs(config_dir, tmp_path, ["data.db.first_round_clean=True",
                                             "data.db.shuffle_while_writing=False"])
    source, _ = construct_datasets(cfg.data)
    ours = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0, device="cpu").baked
    ref = jax_baked.BakedDataset(ours.dir)
    assert ref.meta == ours.meta and ref.images.shape == (2, 32, 32, 32, 3)
    np.testing.assert_array_equal(ref.round(0).images, source.images)
    np.testing.assert_array_equal(ref.labels, np.stack([source.labels] * 2))
    round1 = ref.round(1).images
    for image, src in zip(round1, source.images):
        assert (_windows(src) == image).all(axis=(1, 2, 3)).any()
    assert not np.array_equal(round1, source.images)


def test_jax_store_is_reused(config_dir, tmp_path, monkeypatch):
    jcfg, cfg = _configs(config_dir, tmp_path, [])
    ref = jax_databundle(jcfg.data, jcfg.impl, jcfg.hyp, seed=0).baked
    monkeypatch.setattr(baked, "_bake_rounds", lambda *a, **k: pytest.fail("re-baked"))
    bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0, device="cpu")
    assert bundle.baked.dir == ref.dir and not bundle.augmentations_active
    np.testing.assert_array_equal(bundle.train.images, np.asarray(ref.flat().images))
    np.testing.assert_array_equal(bundle.train.labels, ref.flat().labels)
    for r in range(3):
        np.testing.assert_array_equal(bundle.baked.round(r).images, ref.round(r).images)
        np.testing.assert_array_equal(bundle.baked.round(r).labels, ref.round(r).labels)


def test_rebuild_existing_database_rebakes(config_dir, tmp_path):
    _, cfg = _configs(config_dir, tmp_path, [])
    first = construct_databundle(cfg.data, seed=0, device="cpu").baked
    original = _store_files(first.dir)
    images = np.load(first.dir / "images.npy", mmap_mode="r+")
    images[:] = 0
    images.flush()
    del images
    reused = construct_databundle(cfg.data, seed=0, device="cpu").baked
    assert not reused.images.any()
    del first, reused  # the rebuild truncates the file under their maps
    cfg.data.db.rebuild_existing_database = True
    rebuilt = construct_databundle(cfg.data, seed=0, device="cpu").baked
    assert rebuilt.dir.name.startswith("CIFAR10_32_rounds2_")
    assert _store_files(rebuilt.dir) == original


def test_temporary_database_is_removed_at_exit(tmp_path):
    script = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.data import construct_databundle
cfg = load_config({str(ROOT / 'config')!r}, overrides=[
    'data.size=32', 'data.path=/tmp/__torch_nodata__', 'data/db=baked',
    'data.db.path={tmp_path / 'db'}', 'data.db.rounds=1', 'data.db.temporary_database=True'])
bundle = construct_databundle(cfg.data, device='cpu')
assert (bundle.baked.dir / 'meta.json').exists()
print('DB_DIR=' + str(bundle.baked.dir))
"""
    run = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=240)
    assert run.returncode == 0, run.stdout + run.stderr
    folder = [line[7:] for line in run.stdout.splitlines() if line.startswith("DB_DIR=")][0]
    assert "_tmp" in folder and not pathlib.Path(folder).exists()
    assert (tmp_path / "db").exists()


@pytest.mark.parametrize("shuffle", [True, False])
def test_semi_stochastic_staging_matches_jax(shuffle, config_dir, tmp_path):
    """The resident path (one ``index_select`` into the whole store) and the
    host path (the step's round gathered on the host) stage the same rows as
    the JAX ``stage_epoch``, for rounds 0, 1 and 0 again (steps 0, 1, 3)."""
    extra = ["model=resnet18", "model.width=4", "hyp=base_sgd", "data.batch_size=8",
             "hyp.sub_batch=4", "hyp.train_semi_stochastic=True", f"hyp.shuffle={shuffle}",
             "impl.block_grouping=1", "impl.eval_block_chunks=1", "seed=5"]
    jcfg, cfg = _configs(config_dir, tmp_path, extra)
    jbundle = jax_databundle(jcfg.data, jcfg.impl, jcfg.hyp, seed=0)
    mesh = make_mesh(jcfg.impl.setup, devices=np.asarray(jax.devices()[:1]))
    fns = make_train_functions(jax_construct_model(jcfg.model, jbundle.channels,
                                                   jbundle.classes), jbundle, mesh, jcfg)
    bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0, device="cpu")
    model = construct_model(cfg.model, bundle.channels, bundle.classes)
    resident = Trainer(model, bundle, cfg, torch.device("cpu"))
    cfg.impl.device_shuffle_max_bytes = bundle.train.images.nbytes - 1
    host = Trainer(model, bundle, cfg, torch.device("cpu"))
    assert resident.semi and resident.images is not None and host.images is None
    assert (resident.num_blocks, resident.chunks, resident.sub) == (4, 2, 4)
    for step in (0, 1, 3):
        images, labels = stage_epoch(jbundle, fns, mesh, jcfg, step, {})
        ref = (np.asarray(images).reshape(8, 4, 32, 32, 3), np.asarray(labels).reshape(8, 4))
        for trainer in (resident, host):
            ours = trainer.stage(step)
            np.testing.assert_array_equal(ours[0].numpy(), ref[0])
            np.testing.assert_array_equal(ours[1].numpy(), ref[1])
    first, again = resident.stage(0)[0], resident.stage(2)[0]
    assert torch.equal(first, again) != shuffle  # round 0 twice, in a new order when shuffled
    assert not torch.equal(resident.stage(1)[0], first)
    assert json.loads((bundle.baked.dir / "meta.json").read_text())["rounds"] == 2
