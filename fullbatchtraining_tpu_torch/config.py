"""Hydra-compatible configuration engine (the port's own copy of
``fullbatchtraining_tpu/config.py``; the port imports nothing of the JAX
package).

It composes the shared ``config/`` tree the way Hydra 1.x does:

* a root yaml (``config/cfg.yaml``) with a ``defaults:`` list composing
  option groups (``data``, ``model``, ``impl``, ``hyp``, ``analysis``, ``viz``),
* nested defaults lists inside group files,
* command-line overrides ``key.path=value`` with yaml-typed value parsing,
* group switches ``hyp=gradreg`` / ``hyp/optim=adam``,
* ``+key=value`` additions and ``~key`` deletions,
* ``${a.b.c}`` interpolation (resolved after composition),
* ``--multirun`` choice sweeps (:func:`expand_multirun`).
"""

from __future__ import annotations

import copy
import itertools
import re
from pathlib import Path
from typing import Any, Iterable

import yaml

__all__ = ["ConfigNode", "load_config", "to_yaml", "from_dict", "expand_multirun"]


class ConfigNode(dict):
    """dict with attribute access and deep-merge support."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as err:
            raise AttributeError(f"Config has no key {name!r}. Available: {list(self)}") from err

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as err:
            raise AttributeError(name) from err

    def __deepcopy__(self, memo):
        return ConfigNode({k: copy.deepcopy(v, memo) for k, v in self.items()})

    # OmegaConf-style convenience: cfg.get('a', default) already exists on dict.


_SCI_FLOAT = re.compile(r"[-+]?(\d+(\.\d*)?|\.\d+)[eE][-+]?\d+")


class _YamlLoader(yaml.SafeLoader):
    """SafeLoader + YAML 1.2-style float resolution for PLAIN scalars.

    pyyaml implements YAML 1.1, where ``5e-4`` (no dot in the mantissa) is a
    string; OmegaConf/Hydra parse it as a float. Registering an implicit
    resolver reproduces the 1.2 behavior at PARSE time, so it applies only
    to unquoted scalars — a deliberately quoted ``'1e-3'`` stays a string,
    exactly as under Hydra (a post-hoc string coercion could not tell the
    two apart and would destroy quoted values)."""


_YamlLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(r"^[-+]?(\d+(\.\d*)?|\.\d+)[eE][-+]?\d+$"),
    list("-+0123456789."))


def from_dict(d: Any) -> Any:
    """Recursively convert plain dicts to ConfigNodes (no value coercion:
    scientific-notation floats are resolved at YAML parse time by
    :class:`_YamlLoader`)."""
    if isinstance(d, dict):
        return ConfigNode({k: from_dict(v) for k, v in d.items()})
    if isinstance(d, (list, tuple)):
        return [from_dict(v) for v in d]
    return d


def _deep_merge(base: ConfigNode, incoming: dict) -> ConfigNode:
    """Merge ``incoming`` into ``base`` (incoming wins), recursing into dicts."""
    for key, value in incoming.items():
        if key in base and isinstance(base[key], dict) and isinstance(value, dict):
            _deep_merge(base[key], value)
        else:
            base[key] = from_dict(value)
    return base


def _load_yaml(path: Path) -> dict:
    with open(path) as handle:
        data = yaml.load(handle, Loader=_YamlLoader)
    return data if data is not None else {}


def _parse_value(text: str) -> Any:
    """Parse an override value with yaml typing: unquoted ``1e-2`` is a
    float (_YamlLoader), while explicitly quoted values — quotes that
    survive the shell, e.g. ``name="'1e-3'"`` — stay strings, as under
    Hydra's grammar."""
    if text == "":
        return None
    try:
        return yaml.load(text, Loader=_YamlLoader)
    except yaml.YAMLError:
        return text


class _Composer:
    def __init__(self, config_dir: Path):
        self.config_dir = Path(config_dir)
        # group path (e.g. 'hyp/optim') -> option name, from CLI group overrides
        self.group_choices: dict[str, str] = {}

    def compose_file(self, path: Path, group_dir: Path) -> ConfigNode:
        """Load a yaml file, honoring its defaults list (defaults first, then self)."""
        raw = _load_yaml(path)
        defaults = raw.pop("defaults", [])
        node = ConfigNode()
        for entry in defaults:
            if entry == "_self_":
                _deep_merge(node, raw)
                raw = {}
                continue
            if isinstance(entry, str):
                # e.g. '- _default_hyperparams': sibling file merged in place.
                sibling = group_dir / f"{entry}.yaml"
                _deep_merge(node, self.compose_file(sibling, group_dir))
                continue
            if isinstance(entry, dict):
                for key, option in entry.items():
                    key = key.replace("override ", "").strip()
                    if key.startswith("hydra/") or key == "hydra":
                        continue  # logging config handled natively
                    self._compose_group(node, group_dir, key, option)
                continue
            raise ValueError(f"Unsupported defaults entry {entry!r} in {path}")
        _deep_merge(node, raw)
        return node

    def _compose_group(self, node: ConfigNode, group_dir: Path, key: str, option: Any) -> None:
        rel = (group_dir / key).relative_to(self.config_dir).as_posix()
        option = self.group_choices.get(rel, option)
        subgroup_dir = group_dir / key
        target = node
        *parents, leaf = key.split("/")
        for part in parents:
            target = target.setdefault(part, ConfigNode())
        if option is None:
            target[leaf] = ConfigNode({"name": None})
            return
        option_file = subgroup_dir / f"{option}.yaml"
        if not option_file.exists():
            available = sorted(p.stem for p in subgroup_dir.glob("*.yaml"))
            raise FileNotFoundError(
                f"Config group '{rel}' has no option '{option}'. Available: {available}"
            )
        composed = self.compose_file(option_file, subgroup_dir)
        existing = target.get(leaf)
        if isinstance(existing, dict):
            _deep_merge(existing, composed)
        else:
            target[leaf] = composed


_GROUP_SEP = re.compile(r"[/.]")


def load_config(
    config_dir: str | Path,
    config_name: str = "cfg",
    overrides: Iterable[str] = (),
) -> ConfigNode:
    """Compose the configuration exactly like the reference's Hydra entrypoint."""
    config_dir = Path(config_dir)
    composer = _Composer(config_dir)

    key_overrides: list[tuple[str, str, Any]] = []  # (mode, key, value)
    hydra_overrides: dict[str, Any] = {}
    for raw in overrides:
        raw = raw.strip()
        if not raw:
            continue
        if raw.startswith("~"):
            key_overrides.append(("del", raw[1:].split("=")[0], None))
            continue
        mode = "add" if raw.startswith("+") else "set"
        body = raw[1:] if mode == "add" else raw
        if "=" not in body:
            raise ValueError(f"Override {raw!r} must look like key=value")
        key, text = body.split("=", 1)
        key = key.strip()
        if key == "hydra" or key.startswith(("hydra/", "hydra.")):
            # hydra framework config: run/sweep dir + chdir overrides are
            # honored natively by utils.job_startup via the private _hydra
            # node (popped there, never part of the job config); everything
            # else (job_logging, launcher internals) has nothing to configure.
            if key in ("hydra.run.dir", "hydra.sweep.dir", "hydra.job.chdir"):
                hydra_overrides[key.removeprefix("hydra.")] = _parse_value(text)
            continue
        # Group override? key (with . or / separators) names a directory of options.
        group_rel = "/".join(_GROUP_SEP.split(key))
        if (config_dir / group_rel).is_dir() and mode == "set":
            composer.group_choices[group_rel] = text.strip() or None
        else:
            key_overrides.append((mode, key, _parse_value(text)))

    cfg = composer.compose_file(config_dir / f"{config_name}.yaml", config_dir)

    for mode, key, value in key_overrides:
        _apply_key_override(cfg, mode, key, value)

    _resolve_interpolations(cfg, cfg)

    # Hydra strips its own framework node from the job config; its live
    # settings (run/sweep dir patterns + job.chdir, from the cfg.yaml block
    # after ${...} interpolation, CLI hydra.* overrides winning) ride the
    # private _hydra node, which utils.job_startup consumes and pops.
    hydra_node = cfg.pop("hydra", None) or {}
    hydra_settings = {}
    for dotted in ("run.dir", "sweep.dir", "job.chdir"):
        group, leaf = dotted.split(".")
        sub = hydra_node.get(group)
        if isinstance(sub, dict) and sub.get(leaf) is not None:
            hydra_settings[dotted] = sub[leaf]
    hydra_settings.update(hydra_overrides)
    # CLI hydra.* values arrive after the tree-wide interpolation pass, so
    # resolve ${...} references against the composed job config here (Hydra
    # resolves `hydra.run.dir='${base_dir}/exp'` the same way); ${now:...}
    # survives untouched — _INTERP rejects ':' — for job_startup to expand.
    hydra_settings = {k: _resolve_interpolations(v, cfg)
                      for k, v in hydra_settings.items()}
    if hydra_settings:
        cfg["_hydra"] = ConfigNode(hydra_settings)
    return cfg


def _apply_key_override(cfg: ConfigNode, mode: str, key: str, value: Any) -> None:
    parts = key.split(".")
    node = cfg
    for part in parts[:-1]:
        if mode == "del" and (part not in node or not isinstance(node[part], dict)):
            return
        if part not in node or node[part] is None:
            # 'set' cannot traverse a missing/null group — raising here (as
            # Hydra does) instead of at the leaf avoids mutating cfg with
            # empty intermediate nodes on a failed override
            if mode == "set":
                raise KeyError(
                    f"Could not override '{key}': '{part}' does not exist "
                    f"(use +{key}=... to add)."
                )
            node[part] = ConfigNode()
        elif not isinstance(node[part], dict):
            # never silently destroy an existing scalar (e.g. +data.path.x=1
            # must not wipe the string data.path); Hydra rejects this too
            raise KeyError(
                f"Could not override '{key}': '{part}' holds a "
                f"{type(node[part]).__name__} value, not a config group."
            )
        node = node[part]
    leaf = parts[-1]
    if mode == "del":
        node.pop(leaf, None)
    elif mode == "set" and leaf not in node:
        raise KeyError(
            f"Could not override '{key}': key does not exist (use +{key}=... to add)."
        )
    elif mode == "add" and leaf in node:
        # Hydra: "Could not append to config. An item is already at '<key>'"
        # — a copy-pasted +key on an existing key must not silently replace it
        raise KeyError(
            f"Could not append '+{key}': the key already exists "
            f"(value {node[leaf]!r}); drop the '+' to override it."
        )
    else:
        node[leaf] = from_dict(value)


_SWEEP_FLAGS = ("--multirun", "-m")


def _split_sweep(text: str) -> list[str]:
    """Split an override value on top-level commas (a Hydra choice sweep):
    commas inside brackets or quotes do not split, so ``key=[a,b]`` stays
    one choice and ``key=[a,b],[c,d]`` sweeps two."""
    parts: list[str] = []
    buf: list[str] = []
    depth, quote = 0, None
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch in "[({":
            depth += 1
        elif ch in "])}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append("".join(buf))
            buf = []
            continue
        buf.append(ch)
    parts.append("".join(buf))
    return parts


def expand_multirun(args: Iterable[str]) -> tuple[bool, list[list[str]]]:
    """``(is_multirun, jobs)`` of the command line ``args``, as Hydra's basic
    sweeper expands it. Without ``--multirun``/``-m``, one job of the
    overrides unchanged. With it, each override whose value has top-level
    commas sweeps its choices, and the jobs are the Cartesian product in
    argument order, the last override varying fastest; a ``~key`` deletion
    passes through."""
    args = list(args)
    is_multi = any(a in _SWEEP_FLAGS for a in args)
    overrides = [a for a in args if a not in _SWEEP_FLAGS]
    if not is_multi:
        return False, [overrides]
    choices: list[list[str]] = []
    for raw in overrides:
        if "=" in raw and not raw.startswith("~"):
            key, text = raw.split("=", 1)
            choices.append([f"{key}={v}" for v in _split_sweep(text)])
        else:
            choices.append([raw])
    return True, [list(combo) for combo in itertools.product(*choices)]


_INTERP = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _lookup(root: ConfigNode, dotted: str) -> Any:
    node: Any = root
    for part in dotted.split("."):
        node = node[part]
    return node


def _resolve_interpolations(node: Any, root: ConfigNode) -> Any:
    if isinstance(node, dict):
        for key, value in list(node.items()):
            node[key] = _resolve_interpolations(value, root)
        return node
    if isinstance(node, list):
        return [_resolve_interpolations(v, root) for v in node]
    if isinstance(node, str):
        full = _INTERP.fullmatch(node)
        if full:
            return _resolve_interpolations(_lookup(root, full.group(1)), root)
        # substring interpolation must resolve chained references too
        # (a='${b}/x', b='${c}'), exactly like the full-match branch
        return _INTERP.sub(
            lambda m: str(_resolve_interpolations(_lookup(root, m.group(1)), root)),
            node)
    return node


def to_plain(node: Any) -> Any:
    """A config node as plain dicts and lists (what ``yaml.safe_dump`` and
    ``torch.load(weights_only=True)`` take)."""
    if isinstance(node, dict):
        return {k: to_plain(v) for k, v in node.items()}
    if isinstance(node, list):
        return [to_plain(v) for v in node]
    return node


def to_yaml(cfg: ConfigNode) -> str:
    return yaml.safe_dump(to_plain(cfg), sort_keys=False, default_flow_style=False)
