"""Weights between the JAX package's flax variables and the port's modules.

``load_jax_variables(model, variables)`` fills a port model from
``{"params", "batch_stats"}`` given as nested numpy dicts (the flax tree of
the same architecture); ``export_jax_variables(model)`` is its inverse. The
layout rules are those of ``fullbatchtraining_tpu/pretrained.py``: conv
kernels HWIO <-> OIHW, dense kernels (in, out) <-> (out, in), BN
``scale``/``bias``/``mean``/``var`` <-> ``weight``/``bias``/``running_mean``/
``running_var`` with the flax ``bn`` wrapper level in between. Both are
strict: every port tensor is filled and every JAX leaf used, else they raise.

The optimizer and the rest of a train state move the same way:
``load_jax_sgd_state``/``export_jax_sgd_state`` carry the JAX ``SGDState``
(``momentum``, a tree in the params' layout, and ``count``) to and from
``torch.optim.SGD``'s ``momentum_buffer``s, and ``load_jax_train_state``/
``export_jax_train_state`` a whole JAX ``TrainState`` (as
``flax.serialization.to_state_dict`` gives it: ``step``, ``params``,
``batch_stats``, ``opt_state``, ``ema_params``, ``ema_batch_stats``) to and
from the port's ``TrainState``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .models.layers import BatchNorm2d


def _conv_to_torch(a):
    return a.transpose(3, 2, 0, 1)


def _conv_to_jax(a):
    return a.transpose(2, 3, 1, 0)


def _identity(a):
    return a


def _dense_t(a):
    return a.T


def _leaf_table(model: nn.Module):
    """(port state_dict key, collection, JAX path, to_torch, to_jax) rows."""
    rows = []
    for name, module in model.named_modules():
        prefix = tuple(name.split(".")) if name else ()
        key = f"{name}." if name else ""
        if isinstance(module, BatchNorm2d):
            for port, coll, leaf in (("weight", "params", "scale"), ("bias", "params", "bias"),
                                     ("running_mean", "batch_stats", "mean"),
                                     ("running_var", "batch_stats", "var")):
                rows.append((key + port, coll, prefix + ("bn", leaf), _identity, _identity))
        elif isinstance(module, nn.Conv2d):
            rows.append((key + "weight", "params", prefix + ("kernel",),
                         _conv_to_torch, _conv_to_jax))
            if module.bias is not None:
                rows.append((key + "bias", "params", prefix + ("bias",), _identity, _identity))
        elif isinstance(module, nn.Linear):
            rows.append((key + "weight", "params", prefix + ("kernel",), _dense_t, _dense_t))
            rows.append((key + "bias", "params", prefix + ("bias",), _identity, _identity))
        elif not list(module.children()) and list(module.parameters(recurse=False)):
            raise TypeError(f"no JAX layout known for {type(module).__name__} at {name!r}")
    return rows


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def load_jax_variables(model: nn.Module, variables) -> nn.Module:
    """Copy flax ``variables`` into ``model`` (in place, converting to each
    tensor's dtype); raises on any missing, unused or misshapen leaf."""
    leaves = {coll: _flatten(dict(variables.get(coll, {}))) for coll in ("params", "batch_stats")}
    state = model.state_dict()
    used = set()
    for key, coll, path, to_torch, _ in _leaf_table(model):
        if path not in leaves[coll]:
            raise KeyError(f"JAX {coll} have no leaf {'/'.join(path)} for {key}")
        value = to_torch(np.asarray(leaves[coll][path]))
        if tuple(value.shape) != tuple(state[key].shape):
            raise ValueError(f"{key}: JAX shape {value.shape} vs port {tuple(state[key].shape)}")
        with torch.no_grad():
            state[key].copy_(torch.from_numpy(np.array(value)))
        used.add((coll, path))
    unused = [f"{c}:{'/'.join(p)}" for c, tree in leaves.items() for p in tree
              if (c, p) not in used]
    if unused:
        raise KeyError(f"JAX leaves with no port tensor: {unused}")
    filled = {row[0] for row in _leaf_table(model)}
    missing = sorted(set(state) - filled)
    if missing:
        raise KeyError(f"port tensors no JAX leaf fills: {missing}")
    return model


def export_jax_variables(model: nn.Module) -> dict:
    """The inverse of :func:`load_jax_variables`: nested numpy dicts."""
    state = model.state_dict()
    out = {"params": {}, "batch_stats": {}}
    for key, coll, path, _, to_jax in _leaf_table(model):
        node = out[coll]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(to_jax(state[key].detach().cpu().numpy()))
    return out


def _param_rows(model: nn.Module):
    params = dict(model.named_parameters())
    return [(params[key], path, to_torch, to_jax)
            for key, coll, path, to_torch, to_jax in _leaf_table(model) if coll == "params"]


def load_jax_sgd_state(model: nn.Module, optimizer: torch.optim.Optimizer, sgd_state) -> None:
    """Set the ``momentum_buffer`` of each of ``model``'s params in
    ``optimizer`` from a JAX ``SGDState`` given as ``{"momentum", "count"}``.
    ``count == 0`` (no update yet), or an optimizer without momentum, leaves
    no buffer, as ``torch.optim.SGD`` has none then."""
    leaves = _flatten(dict(sgd_state["momentum"]))
    rows = _param_rows(model)
    unused = set(leaves) - {path for _, path, _, _ in rows}
    if unused:
        raise KeyError(f"JAX momentum leaves with no port tensor: {sorted(unused)}")
    has_buffers = (int(np.asarray(sgd_state["count"])) > 0
                   and any(group["momentum"] for group in optimizer.param_groups))
    for param, path, to_torch, _ in rows:
        if path not in leaves:
            raise KeyError(f"JAX momentum has no leaf {'/'.join(path)}")
        value = torch.from_numpy(np.array(to_torch(np.asarray(leaves[path]))))
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"momentum {'/'.join(path)}: JAX shape {tuple(value.shape)} vs "
                             f"port {tuple(param.shape)}")
        state = optimizer.state[param]
        if has_buffers:
            state["momentum_buffer"] = torch.empty_like(param).copy_(value).detach()
        else:
            state.pop("momentum_buffer", None)


def export_jax_sgd_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """The inverse of :func:`load_jax_sgd_state`: ``{"momentum": nested numpy
    dicts, "count": int32}``, zeros where there is no buffer. ``count`` is 1
    where the buffers exist, else 0: the JAX update reads it only as
    ``count == 0``, and ``torch.optim.SGD`` keeps no count."""
    momentum, count = {}, 0
    for param, path, _, to_jax in _param_rows(model):
        buf = optimizer.state.get(param, {}).get("momentum_buffer")
        count = count or int(buf is not None)
        value = torch.zeros_like(param) if buf is None else buf
        node = momentum
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(to_jax(value.detach().cpu().numpy()))
    return {"momentum": momentum, "count": np.int32(count)}


def load_jax_train_state(state, tree) -> None:
    """Fill the port's ``TrainState`` (model, optimizer, EMA model, step) from
    a JAX ``TrainState`` as nested dicts of arrays."""
    load_jax_variables(state.model, {"params": tree["params"],
                                     "batch_stats": tree["batch_stats"]})
    load_jax_sgd_state(state.model, state.optimizer, tree["opt_state"])
    if (state.ema_model is None) != (tree.get("ema_params") is None):
        raise ValueError("the EMA model is present on one side only")
    if state.ema_model is not None:
        load_jax_variables(state.ema_model, {"params": tree["ema_params"],
                                             "batch_stats": tree["ema_batch_stats"]})
    state.step = int(np.asarray(tree["step"]))


def export_jax_train_state(state) -> dict:
    """The inverse of :func:`load_jax_train_state`."""
    variables = export_jax_variables(state.model)
    ema = None if state.ema_model is None else export_jax_variables(state.ema_model)
    return {"step": np.int32(state.step), "params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "opt_state": export_jax_sgd_state(state.model, state.optimizer),
            "ema_params": None if ema is None else ema["params"],
            "ema_batch_stats": None if ema is None else ema["batch_stats"]}
