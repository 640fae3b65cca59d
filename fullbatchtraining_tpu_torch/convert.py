"""Weights between the JAX package's flax variables and the port's modules.

``load_jax_variables(model, variables)`` fills a port model from
``{"params", "batch_stats"}`` given as nested numpy dicts (the flax tree of
the same architecture); ``export_jax_variables(model)`` is its inverse. The
layout rules are those of ``fullbatchtraining_tpu/pretrained.py``: conv
kernels HWIO <-> OIHW (``WSConv2d``'s too, beside its ``gain``), dense
kernels (in, out) <-> (out, in), norm ``scale``/``bias``/``mean``/``var`` <->
``weight``/``bias``/``running_mean``/``running_var``, one level down where the
JAX norm wraps an inner flax module (the module's ``jax_inner``: ``bn`` of
``BatchNorm2d``, ``gn``/``ln`` of the group and layer norms; none for
``GhostBatchNorm`` and PyramidNet's bare BatchNorms), and the 0-d
``Skipper.alpha`` and ``NFBlock.skip_gain`` as they are. Both are strict:
every port tensor is filled and every JAX leaf used, else they raise. A model
without running stats has an empty ``batch_stats``.

The optimizer and the rest of a train state move the same way:
``load_jax_sgd_state``/``export_jax_sgd_state`` carry the JAX ``SGDState``
(``momentum``, a tree in the params' layout, and ``count``) to and from
``torch.optim.SGD``'s ``momentum_buffer``s, and ``load_jax_train_state``/
``export_jax_train_state`` a whole JAX ``TrainState`` (as
``flax.serialization.to_state_dict`` gives it: ``step``, ``params``,
``batch_stats``, ``opt_state``, ``ema_params``, ``ema_batch_stats``) to and
from the port's ``TrainState``.

The optimizer zoo's states move through ``load_jax_opt_state``/
``export_jax_opt_state``, by the port optimizer's type: ``SGDState`` for SGD
and GD-AGC, ``AdamWState`` (``mu``, ``nu``, ``nu_max``, ``count``) for
AdamW's ``exp_avg``/``exp_avg_sq``/``max_exp_avg_sq``/``step``,
``AdaptiveClipState`` (``sgd``, ``norm_history``, ``count``) and
``FISTAState`` (``x_prev``, ``tk``); LARS/LARC carry their inner optimizer's.
A closure driver's checkpoint payload moves through
``load_jax_driver_state``/``export_jax_driver_state``: loss windows as they
are, FISTA's ``x_prev`` tree to a list in ``parameters()`` order, and each
L-BFGS flat vector from the JAX ``ravel_pytree`` order (sorted flax keys,
HWIO/IO layouts) to the port's (``parameters()`` order, OIHW/``[out, in]``),
segment by segment through the leaf table.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .models.layers import BatchNorm2d, GroupNorm2d, LayerNorm2d, WSConv2d
from .models.modules import GhostBatchNorm, Skipper
from .models.nfnets import NFBlock


def _conv_to_torch(a):
    return a.transpose(3, 2, 0, 1)


def _conv_to_jax(a):
    return a.transpose(2, 3, 1, 0)


def _identity(a):
    return a


def _dense_t(a):
    return a.T


_NORM_LEAVES = (("weight", "params", "scale"), ("bias", "params", "bias"),
                ("running_mean", "batch_stats", "mean"), ("running_var", "batch_stats", "var"))


def _module_rows(module: nn.Module, key: str, prefix: tuple):
    """The rows of ``module``'s own tensors (not its children's)."""
    if isinstance(module, (BatchNorm2d, GhostBatchNorm, GroupNorm2d, LayerNorm2d)):
        inner = (module.jax_inner,) if module.jax_inner else ()
        own = dict(module.named_parameters(recurse=False))
        own.update(module.named_buffers(recurse=False))
        return [(key + port, coll, prefix + inner + (leaf,), _identity, _identity)
                for port, coll, leaf in _NORM_LEAVES if port in own]
    if isinstance(module, (nn.Conv2d, WSConv2d)):
        rows = [(key + "weight", "params", prefix + ("kernel",), _conv_to_torch, _conv_to_jax)]
        if isinstance(module, WSConv2d):
            rows.append((key + "gain", "params", prefix + ("gain",), _identity, _identity))
        if module.bias is not None:
            rows.append((key + "bias", "params", prefix + ("bias",), _identity, _identity))
        return rows
    if isinstance(module, nn.Linear):
        return [(key + "weight", "params", prefix + ("kernel",), _dense_t, _dense_t),
                (key + "bias", "params", prefix + ("bias",), _identity, _identity)]
    own = {Skipper: "alpha", NFBlock: "skip_gain"}.get(type(module))
    if own:
        return [(key + own, "params", prefix + (own,), _identity, _identity)]
    return []


def _leaf_table(model: nn.Module):
    """(port state_dict key, collection, JAX path, to_torch, to_jax) rows."""
    rows = []
    for name, module in model.named_modules():
        prefix = tuple(name.split(".")) if name else ()
        key = f"{name}." if name else ""
        mine = _module_rows(module, key, prefix)
        covered = {row[0] for row in mine}
        tensors = [*module.named_parameters(recurse=False), *module.named_buffers(recurse=False)]
        if any(key + t not in covered for t, _ in tensors):
            raise TypeError(f"no JAX layout known for {type(module).__name__} at {name!r}")
        rows += mine
    return rows


def jax_shapes(model: nn.Module) -> dict:
    """``{(collection, JAX path): JAX shape}`` of every leaf of ``model``'s
    flax tree, read from the shapes alone (a ``meta`` model does)."""
    state = model.state_dict()
    return {(coll, path): to_jax(np.empty(tuple(state[key].shape), np.float32)).shape
            for key, coll, path, _, to_jax in _leaf_table(model)}


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
    leaves = {coll: _flatten(dict(variables.get(coll) or {}))
              for coll in ("params", "batch_stats")}
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
        node[path[-1]] = np.array(to_jax(state[key].detach().cpu().numpy()), order="C")
    return out


def jax_param_paths(model: nn.Module) -> list[str]:
    """The JAX path of each of ``model``'s params, in ``parameters()`` order,
    as ``jax.tree_util.keystr`` writes it for the flax tree, lowercased
    (``"['layer1_block0']['bn1']['bn']['scale']"``): the strings that the JAX
    package's weight-decay and AGC patterns are matched against."""
    paths = {id(param): "".join(f"['{part}']" for part in path).lower()
             for param, path, _, _ in _param_rows(model)}
    return [paths[id(p)] for p in model.parameters()]


def _param_rows(model: nn.Module):
    """(param, JAX path, to_torch, to_jax) rows in ``parameters()`` order."""
    params = dict(model.named_parameters())
    rows = {id(params[key]): (params[key], path, to_torch, to_jax)
            for key, coll, path, to_torch, to_jax in _leaf_table(model) if coll == "params"}
    return [rows[id(p)] for p in model.parameters()]


def params_from_jax(model: nn.Module, tree) -> list:
    """A tree in the layout of the JAX params (nested dicts of arrays) as a
    list of tensors in ``model.parameters()`` order; strict, as
    :func:`load_jax_variables`."""
    leaves = _flatten(dict(tree))
    rows = _param_rows(model)
    unused = set(leaves) - {path for _, path, _, _ in rows}
    if unused:
        raise KeyError(f"JAX leaves with no port tensor: {sorted(unused)}")
    out = []
    for param, path, to_torch, _ in rows:
        if path not in leaves:
            raise KeyError(f"JAX tree has no leaf {'/'.join(path)}")
        value = torch.from_numpy(np.array(to_torch(np.asarray(leaves[path]))))
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{'/'.join(path)}: JAX shape {tuple(value.shape)} vs "
                             f"port {tuple(param.shape)}")
        out.append(value)
    return out


def params_to_jax(model: nn.Module, tensors) -> dict:
    """The inverse of :func:`params_from_jax`: nested numpy dicts."""
    out = {}
    for (_, path, _, to_jax), value in zip(_param_rows(model), tensors, strict=True):
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.array(to_jax(value.detach().cpu().numpy()), order="C")
    return out


def _ravel_segments(model: nn.Module):
    """(index in ``parameters()`` order, JAX shape) of each segment of a JAX
    ``ravel_pytree`` vector of the params: the leaves in sorted-key order."""
    rows = _param_rows(model)
    shapes = jax_shapes(model)
    index = {path: i for i, (_, path, _, _) in enumerate(rows)}
    return [(index[path], shapes["params", path]) for path in sorted(index)]


def flat_from_jax(model: nn.Module, vec) -> torch.Tensor:
    """A JAX ``ravel_pytree`` vector of the params as the port's flat vector
    (``parameters()`` order, the port's layouts)."""
    vec = np.asarray(vec)
    rows = _param_rows(model)
    parts, offset = [None] * len(rows), 0
    for i, shape in _ravel_segments(model):
        n = int(np.prod(shape))
        parts[i] = rows[i][2](vec[offset:offset + n].reshape(shape)).reshape(-1)
        offset += n
    if offset != vec.size:
        raise ValueError(f"JAX vector of {vec.size} elements for {offset} params")
    return torch.from_numpy(np.ascontiguousarray(np.concatenate(parts)))


def flat_to_jax(model: nn.Module, vec) -> np.ndarray:
    """The inverse of :func:`flat_from_jax`."""
    vec = vec.detach().cpu().numpy()
    rows = _param_rows(model)
    pieces, offset = [], 0
    for p, _, _, to_jax in rows:
        pieces.append(to_jax(vec[offset:offset + p.numel()].reshape(tuple(p.shape))))
        offset += p.numel()
    if offset != vec.size:
        raise ValueError(f"port vector of {vec.size} elements for {offset} params")
    return np.concatenate([pieces[i].reshape(-1) for i, _ in _ravel_segments(model)])


def load_jax_sgd_state(model: nn.Module, optimizer: torch.optim.Optimizer, sgd_state) -> None:
    """Set the ``momentum_buffer`` of each of ``model``'s params in
    ``optimizer`` from a JAX ``SGDState`` given as ``{"momentum", "count"}``.
    ``count == 0`` (no update yet), or an optimizer without momentum, leaves
    no buffer, as ``torch.optim.SGD`` has none then."""
    values = params_from_jax(model, sgd_state["momentum"])
    has_buffers = (int(np.asarray(sgd_state["count"])) > 0
                   and any(group["momentum"] for group in optimizer.param_groups))
    for param, value in zip(model.parameters(), values):
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
    bufs = [optimizer.state.get(p, {}).get("momentum_buffer") for p in model.parameters()]
    momentum = params_to_jax(model, [torch.zeros_like(p) if b is None else b
                                     for p, b in zip(model.parameters(), bufs)])
    return {"momentum": momentum, "count": np.int32(any(b is not None for b in bufs))}


def _get(state, key):
    return state[key] if isinstance(state, dict) else getattr(state, key)


def load_jax_opt_state(model: nn.Module, optimizer, opt_state) -> None:
    """Fill the port ``optimizer`` (of :func:`~.training.optimizers.optim_interface`)
    from the JAX optimizer state of the same configuration, as nested dicts
    (or NamedTuples) of arrays."""
    from .training.opt.adaptive_clipping import AdaptiveClippedSGD
    from .training.opt.fista import FISTA
    from .training.opt.lars import LARS
    if optimizer is None:   # L-BFGS: the JAX state holds only a count
        return
    if isinstance(optimizer, LARS):
        return load_jax_opt_state(model, optimizer.inner, opt_state)
    if isinstance(optimizer, AdaptiveClippedSGD):
        load_jax_sgd_state(model, optimizer, _get(opt_state, "sgd"))
        optimizer.norm_history = torch.from_numpy(
            np.array(_get(opt_state, "norm_history"))).to(optimizer.norm_history)
        optimizer.count = torch.tensor(int(np.asarray(_get(opt_state, "count"))),
                                       dtype=optimizer.count.dtype,
                                       device=optimizer.count.device)
        return
    if isinstance(optimizer, torch.optim.SGD):
        sgd = opt_state if isinstance(opt_state, dict) else opt_state._asdict()
        return load_jax_sgd_state(model, optimizer, sgd)
    params = [p for p, _, _, _ in _param_rows(model)]
    if isinstance(optimizer, torch.optim.AdamW):
        count = int(np.asarray(_get(opt_state, "count")))
        amsgrad = optimizer.param_groups[0]["amsgrad"]
        trees = {"exp_avg": "mu", "exp_avg_sq": "nu"}
        if amsgrad:
            trees["max_exp_avg_sq"] = "nu_max"
        values = {k: params_from_jax(model, _get(opt_state, v)) for k, v in trees.items()}
        for i, p in enumerate(params):
            optimizer.state.pop(p, None)
            if count:
                optimizer.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                                      **{k: v[i].to(p).detach() for k, v in values.items()}}
        return
    if isinstance(optimizer, FISTA):
        for p, v in zip(params, params_from_jax(model, _get(opt_state, "x_prev"))):
            optimizer.state[p]["x_prev"] = v.to(p).detach()
        optimizer.tk = float(np.float32(np.asarray(_get(opt_state, "tk"))))
        return
    raise TypeError(f"no JAX optimizer state known for {type(optimizer).__name__}")


def export_jax_opt_state(model: nn.Module, optimizer) -> dict:
    """The inverse of :func:`load_jax_opt_state`, as nested numpy dicts (the
    JAX NamedTuple's fields as keys)."""
    from .training.opt.adaptive_clipping import AdaptiveClippedSGD
    from .training.opt.fista import FISTA
    from .training.opt.lars import LARS
    if optimizer is None:
        return {"momentum": None, "count": np.int32(0)}
    if isinstance(optimizer, LARS):
        return export_jax_opt_state(model, optimizer.inner)
    if isinstance(optimizer, AdaptiveClippedSGD):
        return {"sgd": export_jax_sgd_state(model, optimizer),
                "norm_history": optimizer.norm_history.detach().cpu().numpy(),
                "count": np.int32(int(optimizer.count))}
    if isinstance(optimizer, torch.optim.SGD):
        return export_jax_sgd_state(model, optimizer)
    params = [p for p, _, _, _ in _param_rows(model)]
    if isinstance(optimizer, torch.optim.AdamW):
        amsgrad = optimizer.param_groups[0]["amsgrad"]
        states = [optimizer.state.get(p, {}) for p in params]

        def tree(key):
            return params_to_jax(model, [s.get(key, torch.zeros_like(p))
                                         for s, p in zip(states, params)])
        count = int(float(states[0]["step"])) if states[0] else 0
        return {"mu": tree("exp_avg"), "nu": tree("exp_avg_sq"),
                "nu_max": tree("max_exp_avg_sq") if amsgrad else None,
                "count": np.int32(count)}
    if isinstance(optimizer, FISTA):
        # before the first step the JAX x_prev is the params themselves
        x_prev = [optimizer.state.get(p, {}).get("x_prev", p) for p in params]
        return {"x_prev": params_to_jax(model, x_prev), "tk": np.float32(optimizer.tk)}
    raise TypeError(f"no JAX optimizer state known for {type(optimizer).__name__}")


_LBFGS_VECTORS = ("prev_flat_grad", "Bs", "d")


def load_jax_driver_state(model: nn.Module, payload) -> dict:
    """A JAX closure driver's ``get_state()`` payload as the port driver's."""
    payload = dict(payload)
    if "s_hist" in payload:
        def vec(v):
            v = np.asarray(v)
            return torch.zeros((0,), dtype=torch.float32) if not v.size else flat_from_jax(model, v)
        for key in ("s_hist", "y_hist"):
            payload[key] = [vec(v) for v in payload[key]]
        for key in _LBFGS_VECTORS:
            payload[key] = vec(payload[key])
    elif "x_prev" in payload:
        payload["x_prev"] = params_from_jax(model, payload["x_prev"]) if payload["x_prev"] else []
    return payload


def export_jax_driver_state(model: nn.Module, payload) -> dict:
    """The inverse of :func:`load_jax_driver_state`."""
    payload = dict(payload)
    if "s_hist" in payload:
        def vec(v):
            return np.zeros((0,), np.float32) if not v.numel() else flat_to_jax(model, v)
        for key in ("s_hist", "y_hist"):
            payload[key] = [vec(v) for v in payload[key]]
        for key in _LBFGS_VECTORS:
            payload[key] = vec(payload[key])
    elif "x_prev" in payload:
        payload["x_prev"] = params_to_jax(model, payload["x_prev"]) if payload["x_prev"] else {}
    return payload


def load_jax_train_state(state, tree) -> None:
    """Fill the port's ``TrainState`` (model, optimizer, EMA model, step) from
    a JAX ``TrainState`` as nested dicts of arrays."""
    load_jax_variables(state.model, {"params": tree["params"],
                                     "batch_stats": tree["batch_stats"]})
    load_jax_opt_state(state.model, state.optimizer, tree["opt_state"])
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
            "opt_state": export_jax_opt_state(state.model, state.optimizer),
            "ema_params": None if ema is None else ema["params"],
            "ema_batch_stats": None if ema is None else ema["batch_stats"]}
