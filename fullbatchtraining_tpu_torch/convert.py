"""Weights between the JAX package's flax variables and the port's modules.

``load_jax_variables(model, variables)`` fills a port model from
``{"params", "batch_stats"}`` given as nested numpy dicts (the flax tree of
the same architecture); ``export_jax_variables(model)`` is its inverse. The
layout rules are those of ``fullbatchtraining_tpu/pretrained.py``: conv
kernels HWIO <-> OIHW, dense kernels (in, out) <-> (out, in), BN
``scale``/``bias``/``mean``/``var`` <-> ``weight``/``bias``/``running_mean``/
``running_var`` with the flax ``bn`` wrapper level in between. Both are
strict: every port tensor is filled and every JAX leaf used, else they raise.
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
