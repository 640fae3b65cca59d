"""The upstream project's ``.pth`` checkpoints and the port's models
(``fullbatchtraining_tpu/pretrained.py``).

The upstream project saves a run as the ``torch.save`` list ``[optim_state,
model_state, scheduler_state, scaler_state, step]``; its released ResNets
(:data:`RELEASE_FILES`) are such files. Both sides are PyTorch, so a tensor
moves as it is: no transposes, only NFNet's WSConv2d gains between the
port's ``(C,)`` and the upstream ``(C, 1, 1, 1)``. Each upstream key comes
from the port tensor's JAX path (:mod:`.convert`'s leaf table) through the
JAX package's key rules, copied here: the ResNet layout of each downsample
variant (``stem.{i}``, ``layers.{stage}.{block}.*``, ``fc``), DenseNet's
torchvision layout, VGG's flat ``features``/``classifier``, PyramidNet's
and NFNet's. Every BatchNorm gets a ``num_batches_tracked`` buffer, which
torch's strict ``load_state_dict`` wants. Both directions are strict:
every upstream key is used (``num_batches_tracked`` aside) and every port
tensor filled, else they raise. ``linear`` has no upstream layout, and
SkipInit ResNets differ from the upstream ones in structure; both are
refused.

:func:`export_reference_training_checkpoint` and
:func:`import_reference_training_checkpoint` carry a whole run: for
plain-SGD ResNets also the momentum buffers, keyed by the upstream
``parameters()`` order, and the scheduler's state, replayed with torch's
schedulers. :func:`load_pretrained` builds a release entry's model and
loads it from a local file: the release assets are not in the repository,
and nothing is downloaded.
"""

from __future__ import annotations

import collections
import logging
import re
import warnings
from pathlib import Path

import numpy as np
import torch

from .config import from_dict
from .convert import _leaf_table
from .models import construct_model

log = logging.getLogger(__name__)

# the upstream project's release assets (its hubconf.py)
RELEASE_FILES = {
    "resnet18_fbaug_clip": "final_fbaug_clip_lr04_resnet18.pth",
    "resnet18_fbaug_gradreg": "final_fbaug_gradreg_lr08_resnet18.pth",
    "resnet18_fbaug_gradreg_v2": "final_fbaug_gradreg_lr16_resnet18.pth",
    "resnet18_fbaug_highreg": "final_fbaug_highreg_lr08_resnet18.pth",
    "resnet152_fbaug_highreg": "final_fbaug_highreg_lr08_shuffle_resnet152.pth",
}

# Sequential indices of the downsample branch's conv and norm per variant:
# A = (conv,), B = (conv, norm), C = (pool, conv, norm), preact-B =
# (nonlin, conv), preact-C = (nonlin, pool, conv)
_DOWNSAMPLE_SEQ_INDICES = {
    "A": {"conv": 0},
    "B": {"conv": 0, "norm": 1},
    "C": {"conv": 1, "norm": 2},
    "preact-B": {"conv": 1},
    "preact-C": {"conv": 2},
}

# (JAX collection, leaf name) -> upstream state-dict suffix
_SUFFIX_MAP = {
    ("params", "kernel"): "weight", ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}
_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _checked_suffix(collection: str, leaf: str, parts) -> str:
    try:
        return _SUFFIX_MAP[(collection, leaf)]
    except KeyError:
        if leaf == "alpha":
            raise ValueError(
                "SkipInit ResNets have no upstream state-dict correspondence: the upstream "
                "model keeps post-activation blocks with Skipper layers in the norm slots "
                "(an isinstance check on a class), while the JAX package and this port build "
                "pre-activation SkipInit blocks, so their checkpoints cannot be translated in "
                "either direction.") from None
        raise KeyError(f"No torch suffix for leaf {leaf!r} at {'/'.join(parts)}") from None


def _resnet_key(parts, leaf, collection, downsample_indices) -> str | None:
    """The upstream ResNet key of a JAX path (the ``bn`` level stripped):
    ``stem`` is a Sequential of (conv, bn, nonlin) triples, ``layers`` of
    stage Sequentials of blocks, the classifier ``fc``."""
    name = parts[0]
    suffix = _checked_suffix(collection, leaf, [*parts, leaf])
    if name == "fc":
        return f"fc.{suffix}"
    if name.startswith("stem_conv"):
        return f"stem.{3 * (int(name.removeprefix('stem_conv')) - 1)}.{suffix}"
    if name.startswith("stem_bn"):
        return f"stem.{3 * (int(name.removeprefix('stem_bn')) - 1) + 1}.{suffix}"
    match = re.fullmatch(r"layer(\d+)_block(\d+)", name)
    if match:
        stage, block = int(match.group(1)) - 1, int(match.group(2))
        if parts[1] == "downsample":
            return (f"layers.{stage}.{block}.downsample."
                    f"{downsample_indices[parts[2]]}.{suffix}")
        return f"layers.{stage}.{block}.{parts[1]}.{suffix}"
    return None


def _densenet_key(parts, leaf, collection):
    """torchvision's DenseNet layout: ``features.conv0``/``norm0``,
    ``denseblock{i}.denselayer{j}.{norm,conv}{1,2}``, ``transition{i}``,
    ``norm5``, ``classifier``."""
    suffix = _checked_suffix(collection, leaf, parts)
    name = parts[0]
    if name == "classifier":
        return f"classifier.{suffix}"
    if name.startswith(("stem_conv", "stem_norm")):
        return f"features.{name.removeprefix('stem_')}.{suffix}"
    match = re.fullmatch(r"block(\d+)_layer(\d+)", name)
    if match:
        return f"features.denseblock{match.group(1)}.denselayer{match.group(2)}.{parts[1]}.{suffix}"
    match = re.fullmatch(r"transition(\d+)_(norm|conv)", name)
    if match:
        return f"features.transition{match.group(1)}.{match.group(2)}.{suffix}"
    if name == "final_norm":
        return f"features.norm5.{suffix}"
    raise KeyError(f"Unmapped DenseNet module {name!r}")


def _vgg_key_factory(vgg_name: str, head: str):
    """VGG's flat ``features`` Sequential of (conv, norm, nonlin) a plan
    entry, one more slot a pool; the classifier a bare Linear (CIFAR),
    (pool, Linear) (TinyImageNet) or the ImageNet MLP (Linears at 1, 4, 7)."""
    from .models.vgg import VGG_PLANS

    conv_to_seq, seq, idx = {}, 0, 0
    for entry in VGG_PLANS[vgg_name.upper()]:
        if entry == "M":
            seq += 1
        else:
            conv_to_seq[idx] = seq
            seq += 3
            idx += 1

    def mapper(parts, leaf, collection):
        suffix = _checked_suffix(collection, leaf, parts)
        name = parts[0]
        if name == "classifier":
            return {"CIFAR": f"classifier.{suffix}",
                    "TinyImageNet": f"classifier.1.{suffix}"}.get(head, f"classifier.7.{suffix}")
        if name == "fc1":
            return f"classifier.1.{suffix}"
        if name == "fc2":
            return f"classifier.4.{suffix}"
        kind, i = name[:4], int(name[4:])
        return f"features.{conv_to_seq[i] + (0 if kind == 'conv' else 1)}.{suffix}"

    return mapper


def _nfnet_key(parts, leaf, collection):
    """NFNet's ``stem.conv{n}``, ``body.{i}`` blocks, ``final_conv`` and
    ``linear``; WSConv2d's per-channel ``gain`` and a block's ``skip_gain``."""
    name = parts[0]
    if name.startswith("stem_conv"):
        base, rest = f"stem.conv{name.removeprefix('stem_conv')}", []
    elif name.startswith("block"):
        base, rest = f"body.{name.removeprefix('block')}", parts[1:]
    elif name in ("final_conv", "linear"):
        base, rest = name, []
    else:
        raise KeyError(f"Unmapped NFNet module {name!r}")
    if leaf == "skip_gain":
        return f"{base}.skip_gain"
    suffix = {"kernel": "weight", "gain": "gain", "bias": "bias"}[leaf]
    return ".".join([base, *rest, suffix])


def _pyramidnet_key(parts, leaf, collection):
    """PyramidNet's ``layer{s}`` Sequentials of blocks, their conv and bn
    modules named as here, and the top-level ``conv1``/``bn_final``/``fc``."""
    suffix = _checked_suffix(collection, leaf, parts)
    name = parts[0]
    match = re.fullmatch(r"layer(\d+)_block(\d+)", name)
    if match:
        return f"layer{match.group(1)}.{match.group(2)}.{parts[1]}.{suffix}"
    return f"{name}.{suffix}"


def _family_key_mapper(cfg_model):
    """The key rule of ``cfg_model``'s family (the families of
    ``models.construct_model``), ResNets aside."""
    name = str(cfg_model.name).lower()
    if "densenet" in name:
        return _densenet_key
    if "vgg" in name:
        return _vgg_key_factory(str(cfg_model.name), str(cfg_model.get("head", "CIFAR")))
    if "linear" in name:
        raise ValueError("The linear debug model has no upstream state-dict layout: the "
                         "upstream one is a 2-layer MLP, this one a single Linear; neither is "
                         "released.")
    if "nfnet" in name:
        return _nfnet_key
    if "pyramidnet" in name:
        return _pyramidnet_key
    raise ValueError(f"Unknown model family {cfg_model.name!r} for state-dict interop")


def _rows(model, mapper):
    """``(port key, upstream key, leaf)`` of each of ``model``'s tensors."""
    rows = []
    for key, collection, path, _, _ in _leaf_table(model):
        logical = [p for p in path[:-1] if p != "bn"]
        rows.append((key, mapper(logical, path[-1], collection), path[-1]))
    return rows


def _resnet_mapper(downsample: str):
    if downsample not in _DOWNSAMPLE_SEQ_INDICES:
        raise ValueError(f"Unknown downsample variant {downsample!r}")
    indices = _DOWNSAMPLE_SEQ_INDICES[downsample]

    def mapper(parts, leaf, collection):
        key = _resnet_key(parts, leaf, collection, indices)
        if key is None:
            raise KeyError(f"Cannot map {'/'.join([*parts, leaf])} to an upstream ResNet key")
        return key

    return mapper


def _to_upstream(value: torch.Tensor, leaf: str) -> torch.Tensor:
    value = value.detach().cpu()
    if leaf == "gain":
        value = value.reshape(-1, 1, 1, 1)
    return value.clone(memory_format=torch.contiguous_format)


def _export(model, mapper, step: int) -> dict:
    state = model.state_dict()
    out = {up: _to_upstream(state[key], leaf) for key, up, leaf in _rows(model, mapper)}
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key.replace(".running_mean", ".num_batches_tracked")] = torch.tensor(
            int(step), dtype=torch.int64)
    return out


def export_torch_resnet(model, downsample: str = "C", step: int = 0) -> dict:
    """A port ResNet as the upstream state dict of the ``downsample``
    variant, ``num_batches_tracked`` set to ``step``."""
    return _export(model, _resnet_mapper(downsample), step)


def export_torch_state(model, cfg_model, step: int = 0) -> dict:
    """A port model of ``cfg_model``'s family as the upstream state dict
    (CPU tensors, the model's dtypes)."""
    if "resnet" in str(cfg_model.name).lower():
        return export_torch_resnet(model, str(cfg_model.get("downsample", "C")), step)
    return _export(model, _family_key_mapper(cfg_model), step)


def _as_tensor(value) -> torch.Tensor:
    return value.detach().cpu() if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.asarray(value))


def _fill(model, model_state, keys: dict) -> dict:
    """Copy ``model_state[keys[port key]]`` into each tensor of ``model``;
    every key of ``model_state`` but ``num_batches_tracked`` must be used."""
    unused = {k for k in model_state if not k.endswith(".num_batches_tracked")} - set(keys.values())
    if unused:
        raise KeyError(f"upstream keys no tensor of the model takes: {sorted(unused)[:10]}")
    state = model.state_dict()
    with torch.no_grad():
        for key, up in keys.items():
            state[key].copy_(_as_tensor(model_state[up]).reshape(state[key].shape))
    return keys


def _resolved_keys(model, model_state, mapper, probe_downsample=False) -> dict:
    """``{port key: upstream key}`` for every tensor of ``model``, each of
    the right shape; a ResNet's downsample keys are probed across the
    variants' Sequential indices by shape."""
    state = model.state_dict()
    keys, missing = {}, []
    for key, up, leaf in _rows(model, mapper):
        want = state[key].shape
        candidates = [up]
        if probe_downsample and ".downsample." in up:
            candidates += [re.sub(r"\.downsample\.\d+\.", f".downsample.{i}.", up)
                           for i in range(3)]
        for cand in candidates:
            value = model_state.get(cand)
            if value is not None and _as_tensor(value).numel() == state[key].numel() and (
                    leaf == "gain" or tuple(_as_tensor(value).shape) == tuple(want)):
                keys[key] = cand
                break
        else:
            missing.append(f"{key} ({up})")
    if missing:
        raise KeyError(f"upstream state dict has no tensor for {missing[:10]}")
    return keys


def convert_torch_resnet(model_state: dict, model) -> dict:
    """Fill a port ResNet from an upstream ResNet state dict of any
    downsample variant (probed by shape); returns ``{port key: upstream
    key}``."""
    return _fill(model, model_state,
                 _resolved_keys(model, model_state, _resnet_mapper("C"), probe_downsample=True))


def convert_torch_state(model_state: dict, model, cfg_model) -> dict:
    """Fill a port model of ``cfg_model``'s family from an upstream state
    dict (the inverse of :func:`export_torch_state`); returns ``{port key:
    upstream key}``."""
    if "resnet" in str(cfg_model.name).lower():
        return convert_torch_resnet(model_state, model)
    return _fill(model, model_state,
                 _resolved_keys(model, model_state, _family_key_mapper(cfg_model)))


def save_reference_checkpoint(model, file, cfg_model, step: int = 0, optim_state=None,
                              scheduler_state=None, scaler_state=None) -> Path:
    """The upstream 5-tuple ``[optim_state, model_state, scheduler_state,
    scaler_state, step]`` of ``model`` at ``file``; the optimizer and
    scheduler slots default to empty dicts."""
    model_state = export_torch_state(model, cfg_model, step=step)
    file = Path(file)
    file.parent.mkdir(parents=True, exist_ok=True)
    torch.save([optim_state or {}, model_state, scheduler_state or {}, scaler_state, int(step)],
               file)
    log.info("Exported an upstream-format checkpoint (%d tensors, step %d) to %s",
             len(model_state), step, file)
    return file


def read_reference_checkpoint(file):
    """The five entries of an upstream ``.pth`` (a bare state dict reads as
    ``[{}, state dict, {}, None, 0]``), loaded with ``weights_only=True``
    (the schedulers' ``Counter`` of milestones allowed)."""
    with torch.serialization.safe_globals([collections.Counter]):
        payload = torch.load(file, map_location="cpu", weights_only=True)
    if isinstance(payload, (list, tuple)) and len(payload) == 5:
        optim_state, model_state, scheduler_state, scaler_state, step = payload
        return optim_state, model_state, scheduler_state, scaler_state, int(step)
    return {}, payload, {}, None, 0


# ---------------------------------------------------------------------------
# the optimizer and scheduler slots of the 5-tuple
# ---------------------------------------------------------------------------

def _torch_param_rank(key: str) -> tuple:
    """The place of an upstream ResNet parameter key in the upstream
    ``model.parameters()``: module registration order (stem, then stages
    and blocks, in a block conv/bn in order and downsample last, then fc)."""
    leaf = 0 if key.endswith(".weight") else 1
    parts = key.split(".")
    if parts[0] == "stem":
        return (0, int(parts[1]), 0, 0, leaf)
    if parts[0] == "layers":
        stage, block, inner = int(parts[1]), int(parts[2]), parts[3]
        if inner == "downsample":
            return (1, stage, block, 100 + int(parts[4]), leaf)
        rank = {"conv1": 0, "bn1": 1, "conv2": 2, "bn2": 3, "conv3": 4, "bn3": 5}[inner]
        return (1, stage, block, rank, leaf)
    if parts[0] == "fc":
        return (2, 0, 0, 0, leaf)
    raise KeyError(f"Unknown torch ResNet parameter key {key!r}")


def torch_parameter_keys(model_state: dict) -> list:
    """The upstream ``model.parameters()`` order of a ResNet state dict."""
    params = [k for k in model_state if not k.endswith(_BUFFERS)]
    return sorted(params, key=_torch_param_rank)


def export_torch_sgd_state(momentum_by_key, param_order, lr_next: float, cfg_optim) -> dict:
    """``torch.optim.SGD.state_dict()`` of the 5-tuple's optimizer slot: the
    momentum buffers by upstream key (None or empty before the first step),
    ``param_order`` the upstream parameter keys in order, ``lr_next`` the
    group's lr for the next step (the upstream loop steps its scheduler
    after the optimizer). One param group."""
    state = {}
    if momentum_by_key:
        missing = [k for k in param_order if k not in momentum_by_key]
        if missing:
            raise KeyError(f"Momentum buffers missing for {missing[:5]}")
        state = {i: {"momentum_buffer": _as_tensor(momentum_by_key[k]).clone()}
                 for i, k in enumerate(param_order)}
    group = {
        "lr": float(lr_next),
        "momentum": float(cfg_optim.momentum),
        "dampening": float(cfg_optim.get("dampening", 0.0) or 0.0),
        "weight_decay": float(cfg_optim.get("weight_decay", 0.0) or 0.0),
        "nesterov": bool(cfg_optim.get("nesterov", False)),
        "maximize": False, "foreach": None, "differentiable": False, "fused": None,
        "params": list(range(len(param_order))),
    }
    return {"state": state, "param_groups": [group]}


def import_torch_sgd_state(optim_state: dict, param_order) -> dict:
    """The inverse of :func:`export_torch_sgd_state`: ``{upstream key:
    momentum buffer}``, empty before the first step."""
    buffers = {}
    for idx, slot in (optim_state.get("state") or {}).items():
        buf = slot.get("momentum_buffer")
        if buf is not None:
            buffers[param_order[int(idx)]] = _as_tensor(buf)
    return buffers


def export_torch_scheduler_state(cfg_hyp, steps_done: int, n_groups: int = 1) -> dict:
    """The scheduler slot of the 5-tuple after ``steps_done`` steps: torch's
    schedulers built as the upstream project builds them (MultiStepLR at
    ``steps // 2.667, // 1.6, // 1.142`` for ``linear``, the cosine
    variants, an empty MultiStepLR for none, all inside the upstream
    gradual warm-up when ``hyp.warmup > 0``), stepped ``steps_done`` times
    and serialized as the upstream project does."""
    base_lr = float(cfg_hyp.optim.lr)
    steps = int(cfg_hyp.steps)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1)) for _ in range(n_groups)],
                          lr=base_lr)
    name = cfg_hyp.scheduler
    sched = torch.optim.lr_scheduler
    if name == "linear":
        after = sched.MultiStepLR(opt, milestones=[steps // 2.667, steps // 1.6, steps // 1.142],
                                  gamma=0.1)
    elif name == "exponential":
        after = sched.ExponentialLR(opt, gamma=0.99)
    elif name == "cosine-decay-floored":
        after = sched.CosineAnnealingLR(opt, steps, eta_min=base_lr / 25)
    elif name == "cosine-decay":
        after = sched.CosineAnnealingLR(opt, steps, eta_min=0.0)
    elif name == "cosine-4000":
        after = sched.CosineAnnealingLR(opt, 4000, eta_min=0.0)
    elif name in ("", " ", None):
        after = sched.MultiStepLR(opt, milestones=[], gamma=1)
    else:
        raise ValueError(f"Invalid scheduler {name} provided.")

    def replay(scheduler):
        # the optimizer never steps, which torch warns of on a scheduler's step
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for _ in range(steps_done):
                scheduler.step()

    warmup = int(cfg_hyp.warmup or 0)
    if warmup <= 0:
        replay(after)
        return after.state_dict()

    base = getattr(sched, "LRScheduler", None) or sched._LRScheduler

    class _GradualWarmup(base):
        """The upstream gradual warm-up, for its state only: lr ramps as
        ``base * epoch / total``, the first call past the warm-up re-bases
        the after-scheduler, then ``step`` delegates to it."""

        def __init__(self, optimizer, total_epoch, after_scheduler):
            self.multiplier = 1.0
            self.total_epoch = total_epoch
            self.after_scheduler = after_scheduler
            self.finished = False
            super().__init__(optimizer)

        def get_lr(self):
            if self.last_epoch > self.total_epoch:
                if not self.finished:
                    self.after_scheduler.base_lrs = [b * self.multiplier for b in self.base_lrs]
                    self.finished = True
                return list(self.after_scheduler.get_last_lr())
            return [b * (float(self.last_epoch) / self.total_epoch) for b in self.base_lrs]

        def step(self, epoch=None):
            if self.finished and self.after_scheduler:
                self.after_scheduler.step(epoch - self.total_epoch if epoch is not None else None)
                self._last_lr = list(self.after_scheduler.get_last_lr())
            else:
                super().step(epoch)

    warm = _GradualWarmup(opt, warmup, after)
    replay(warm)
    payload = {k: v for k, v in warm.__dict__.items()
               if k not in ("optimizer", "after_scheduler")}
    payload["after_scheduler"] = {k: v for k, v in after.__dict__.items() if k != "optimizer"}
    return payload


def _sgd(optimizer):
    """The ``torch.optim.SGD`` that holds momentum buffers (LARS/LARC's
    inner one), or None for the other optimizers."""
    from .training.opt.adaptive_clipping import AdaptiveClippedSGD
    from .training.opt.lars import LARS

    if isinstance(optimizer, LARS):
        optimizer = optimizer.inner
    if isinstance(optimizer, torch.optim.SGD) and not isinstance(optimizer, AdaptiveClippedSGD):
        return optimizer
    return None


def export_reference_training_checkpoint(state, cfg, file, schedule=None) -> Path:
    """The upstream 5-tuple of a port ``TrainState`` at ``file``: for a
    plain-SGD ResNet run also the momentum buffers and the scheduler's
    state, so the upstream loop resumes it; for any other run the weights
    alone (empty optimizer and scheduler slots)."""
    from .training.optimizers import make_lr_schedule

    step = int(state.step)
    model = state.model
    optimizer = _sgd(state.optimizer)
    exportable = (cfg.hyp.optim.name == "Gradient Descent"
                  and cfg.hyp.optim.get("line_search", "none") == "none"
                  and not cfg.hyp.get("only_linear_layers_weight_decay", False)
                  and cfg.hyp.optim_modification.name in (None, "none")
                  and optimizer is not None
                  and "resnet" in str(cfg.model.name).lower())
    if not exportable:
        log.info("Optimizer %s (model %s) has no torch-resumable state layout: exporting the "
                 "weights alone (empty optimizer and scheduler slots).", cfg.hyp.optim.name,
                 cfg.model.name)
        return save_reference_checkpoint(model, file, cfg.model, step=step)

    downsample = str(cfg.model.get("downsample", "C"))
    model_state = export_torch_resnet(model, downsample, step)
    momentum_by_key = None
    if step > 0 and float(cfg.hyp.optim.momentum):
        keys = dict((key, up) for key, up, _ in _rows(model, _resnet_mapper(downsample)))
        momentum_by_key = {
            keys[name]: optimizer.state.get(p, {}).get("momentum_buffer", torch.zeros_like(p))
            for name, p in model.named_parameters()}
    schedule = schedule or make_lr_schedule(cfg.hyp)
    optim_state = export_torch_sgd_state(momentum_by_key, torch_parameter_keys(model_state),
                                         float(schedule(step)), cfg.hyp.optim)
    return save_reference_checkpoint(model, file, cfg.model, step=step, optim_state=optim_state,
                                     scheduler_state=export_torch_scheduler_state(cfg.hyp, step))


def import_reference_training_checkpoint(file, cfg, state, schedule=None):
    """Fill a port ``TrainState`` from an upstream ``.pth`` 5-tuple and
    return ``(state, step)``: the weights and running stats for every family
    (the EMA model from the same weights), the momentum buffers for
    plain-SGD ResNets; the saved lr is checked against ``schedule(step)``."""
    from .training.optimizers import make_lr_schedule

    optim_state, model_state, _, scaler_state, step = read_reference_checkpoint(file)
    keys = convert_torch_state(model_state, state.model, cfg.model)
    state.step = step
    if state.ema_model is not None:
        state.ema_model.load_state_dict(state.model.state_dict())

    optimizer = _sgd(state.optimizer)
    if optimizer is not None and "resnet" in str(cfg.model.name).lower() and (
            optim_state or {}).get("state"):
        momentum_by_key = import_torch_sgd_state(optim_state, torch_parameter_keys(model_state))
        for name, p in state.model.named_parameters():
            optimizer.state[p]["momentum_buffer"] = momentum_by_key[keys[name]].to(p).clone()
    elif optim_state:
        log.info("Optimizer slot not importable for model %s (momentum maps for plain-SGD "
                 "ResNets only): continuing with fresh optimizer state.", cfg.model.name)

    groups = (optim_state or {}).get("param_groups") or []
    if groups and "lr" in groups[0]:
        lr_here = float((schedule or make_lr_schedule(cfg.hyp))(step))
        lr_saved = float(groups[0]["lr"])
        if not np.isclose(lr_here, lr_saved, rtol=1e-5, atol=1e-12):
            log.warning("Checkpoint lr %.6g != schedule(%d)=%.6g: the hyp config does not "
                        "match the run that wrote this checkpoint.", lr_saved, step, lr_here)
    if scaler_state:
        log.info("Ignoring the grad-scaler slot: bf16 needs no loss scaling.")
    return state, step


def _model_cfg(depth: int, width: int = 64, downsample: str = "C"):
    return from_dict({
        "name": f"ResNet{depth}", "depth": depth, "width": width, "stem": "CIFAR",
        "convolution": "Standard", "nonlin_fn": "ReLU", "normalization": "BatchNorm2d",
        "downsample": downsample, "initialization": "skip-residual",
    })


def load_pretrained(entry: str, file=None, channels: int = 3, classes: int = 10,
                    pretrained: bool = True):
    """The model of release entry ``entry`` (a port ``nn.Module`` on the
    CPU), loaded from the local ``.pth`` ``file`` where ``pretrained``, else
    at its seeded initial weights."""
    if entry not in RELEASE_FILES:
        raise ValueError(f"Unknown entry {entry}. Available: {sorted(RELEASE_FILES)}")
    model = construct_model(_model_cfg(152 if "152" in entry else 18), channels, classes)
    if not pretrained:
        log.info("pretrained=False: returning randomly initialized %s.", entry)
        return model
    if file is None or "://" in str(file):
        raise FileNotFoundError(
            f"{entry} needs the upstream release asset {RELEASE_FILES[entry]} as a local file: "
            "place it on this machine and pass file=<its path>. Nothing is downloaded.")
    _, model_state, _, _, step = read_reference_checkpoint(file)
    convert_torch_resnet(model_state, model)
    log.info("Loaded %s (trained to step %d).", entry, step)
    return model
