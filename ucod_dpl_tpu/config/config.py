"""Attribute-dict configuration system with ``_BASE_`` inheritance.

Behavioral equivalent of the reference's YACS-fork config
(``engine/config/config.py:66-611`` in Heartfirey/UCOD-DPL): experiment
configs are Python files exporting a ``cfg`` dict (or YAML files), with a
``_BASE_`` list of parent configs resolved relative to the child file and
deep-merged child-over-base.  Supports freeze/defrost, dotted-key CLI
overrides with type coercion, and YAML dump of the resolved config.

The implementation here is original; only the public behavior matches.
"""

from __future__ import annotations

import ast
import copy
import importlib.util
import os
from typing import Any, Dict, Iterable, List


_BASE_KEY = "_BASE_"
_VALID_SCALARS = (int, float, bool, str, type(None))


class CfgNode(dict):
    """A dict subclass with attribute access and optional immutability."""

    _FROZEN = "__cfg_frozen__"

    def __init__(self, init: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = _wrap(v)

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set '{name}' on a frozen CfgNode; call defrost() first"
            )
        self[name] = _wrap(value)

    def __setitem__(self, key: str, value: Any) -> None:
        if self.is_frozen():
            raise KeyError(
                f"Attempted to set '{key}' on a frozen CfgNode; call defrost() first"
            )
        super().__setitem__(key, _wrap(value))

    def __deepcopy__(self, memo):
        node = CfgNode()
        for k, v in self.items():
            dict.__setitem__(node, k, copy.deepcopy(v, memo))
        return node

    # -- mutability ---------------------------------------------------------
    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode._FROZEN)

    def freeze(self) -> "CfgNode":
        self._set_frozen(True)
        return self

    def defrost(self) -> "CfgNode":
        self._set_frozen(False)
        return self

    def _set_frozen(self, flag: bool) -> None:
        object.__setattr__(self, CfgNode._FROZEN, flag)
        for v in self.values():
            _propagate_frozen(v, flag)

    # dict mutators must honour freeze() like __setitem__/__setattr__ do —
    # otherwise cfg.update(...)/pop(...) silently bypass immutability and
    # the dumped/logged config no longer matches what ran
    def _check_mutable(self) -> None:
        if self.is_frozen():
            raise KeyError("Attempted to mutate a frozen CfgNode; call defrost() first")

    def update(self, *args, **kwargs):  # type: ignore[override]
        self._check_mutable()
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def setdefault(self, key, default=None):  # type: ignore[override]
        if key not in self:
            self._check_mutable()
            self[key] = default
        return self[key]

    def pop(self, *args):  # type: ignore[override]
        self._check_mutable()
        return super().pop(*args)

    def popitem(self):  # type: ignore[override]
        self._check_mutable()
        return super().popitem()

    def clear(self):  # type: ignore[override]
        self._check_mutable()
        super().clear()

    def __delitem__(self, key):
        self._check_mutable()
        super().__delitem__(key)

    # -- merge ----------------------------------------------------------------
    def merge(self, other: Dict[str, Any]) -> "CfgNode":
        """Deep-merge ``other`` into self (other wins on conflicts)."""
        for k, v in other.items():
            if (
                k in self
                and isinstance(self[k], CfgNode)
                and isinstance(v, (dict, CfgNode))
            ):
                self[k].merge(v)
            else:
                self[k] = _wrap(copy.deepcopy(v))
        return self

    def merge_from_list(
        self, opts: Iterable[str], allow_new: bool = False
    ) -> "CfgNode":
        """Merge dotted-key/value pairs, e.g. ["train_cfg.lr0", "1e-3"].

        Unknown keys RAISE (the reference's merge_from_list asserts
        "Non-existent key", config.py:289-298) — a typo'd override silently
        creating a dead key (e.g. ``train_loader_cfg`` vs the real
        ``trainloader_cfg``) otherwise leaves the run on defaults with no
        indication.  ``allow_new=True`` restores the create-on-miss
        behaviour for programmatic construction."""
        opts = list(opts)
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list must have even length, got {opts}")
        for dotted, raw in zip(opts[0::2], opts[1::2]):
            keys = dotted.split(".")
            node = self
            for k in keys[:-1]:
                if k not in node:
                    if not allow_new:
                        raise KeyError(
                            f"Non-existent config key: '{dotted}' ('{k}' not found; "
                            f"available: {sorted(node.keys())})"
                        )
                    node[k] = CfgNode()
                node = node[k]
                if not isinstance(node, CfgNode):
                    raise KeyError(f"Cannot descend into non-dict key '{k}' of '{dotted}'")
            leaf = keys[-1]
            if leaf not in node and not allow_new:
                raise KeyError(
                    f"Non-existent config key: '{dotted}' "
                    f"(available: {sorted(node.keys())})"
                )
            old = node.get(leaf, None)
            node[leaf] = _coerce(raw, old)
        return self

    # -- (de)serialisation -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {k: _unwrap(v) for k, v in self.items()}

    def dump_yaml(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(str(self))

    def __str__(self) -> str:
        import yaml  # only YAML configs and config dumps need pyyaml

        return yaml.safe_dump(self.to_dict(), default_flow_style=False, sort_keys=False)


def _wrap(value: Any) -> Any:
    if isinstance(value, CfgNode):
        return value
    if isinstance(value, dict):
        return CfgNode(value)
    if isinstance(value, (list, tuple)):
        t = type(value)
        return t(_wrap(v) for v in value)
    return value


def _unwrap(value: Any) -> Any:
    """Inverse of _wrap for serialisation: CfgNodes (including those nested
    inside lists/tuples, which _wrap creates) become plain dicts — yaml's
    safe representer rejects CfgNode, so a list-of-dicts config would
    otherwise crash dump_yaml()/str()."""
    if isinstance(value, CfgNode):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_unwrap(v) for v in value]
    return copy.deepcopy(value)


def _propagate_frozen(value: Any, flag: bool) -> None:
    """freeze()/defrost() must reach CfgNodes nested inside lists/tuples
    (which _wrap creates) — not only direct dict children."""
    if isinstance(value, CfgNode):
        value._set_frozen(flag)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _propagate_frozen(v, flag)


def _coerce(raw: str, old: Any) -> Any:
    """Parse a string override, preferring the type of the existing value."""
    try:
        parsed = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        parsed = raw
    if isinstance(parsed, bool) and isinstance(old, int) and not isinstance(old, bool):
        # bool IS an int subclass, so the type-match below would silently
        # turn e.g. max_epoch into True (== 1) on a typo'd override
        raise ValueError(f"Cannot coerce boolean override {raw!r} to int")
    if old is None or isinstance(parsed, type(old)):
        return parsed
    # numeric cross-coercion (int config value overridden with "1e-3" etc.)
    if isinstance(old, bool):
        if isinstance(parsed, str):
            if parsed.lower() in ("true", "1", "yes"):
                return True
            if parsed.lower() in ("false", "0", "no"):
                return False
        return bool(parsed)
    if isinstance(old, float) and isinstance(parsed, int):
        return float(parsed)
    if isinstance(old, int) and isinstance(parsed, float) and parsed.is_integer():
        return int(parsed)
    if isinstance(old, (list, tuple)) and isinstance(parsed, (list, tuple)):
        return type(old)(parsed)
    if isinstance(parsed, str) and not isinstance(old, str):
        raise ValueError(f"Cannot coerce override {raw!r} to type {type(old).__name__}")
    return parsed


def _load_py_cfg(path: str) -> Dict[str, Any]:
    spec = importlib.util.spec_from_file_location("_ucod_cfg_module", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # type: ignore[union-attr]
    if not hasattr(mod, "cfg"):
        raise ValueError(f"Config file {path} must define a module-level 'cfg' dict")
    return copy.deepcopy(mod.cfg)


def _load_yaml_cfg(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    return data or {}


def _load_raw(path: str) -> Dict[str, Any]:
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.exists(path):
        raise FileNotFoundError(f"Config file not found: {path}")
    if path.endswith(".py"):
        return _load_py_cfg(path)
    if path.endswith((".yaml", ".yml")):
        return _load_yaml_cfg(path)
    raise ValueError(f"Unsupported config extension: {path}")


def load_config(path: str, overrides: List[str] | None = None) -> CfgNode:
    """Load a config file, recursively resolving its ``_BASE_`` chain.

    Bases are listed relative to the child file and merged in order, with
    later bases and finally the child overriding earlier values — matching
    the reference's ``CfgNode.load_with_base``
    (``engine/config/config.py:140-191``).
    """
    path = os.path.abspath(os.path.expanduser(path))
    raw = _load_raw(path)
    bases = raw.pop(_BASE_KEY, [])
    if isinstance(bases, str):
        bases = [bases]

    merged = CfgNode()
    for base_rel in bases:
        base_path = base_rel
        if not os.path.isabs(base_path):
            base_path = os.path.join(os.path.dirname(path), base_rel)
        merged.merge(load_config(base_path, overrides=None))
    merged.merge(raw)

    if overrides:
        merged.merge_from_list(overrides)
    return merged
