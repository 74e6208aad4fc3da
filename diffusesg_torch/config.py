"""Locked hierarchical configuration with reference-compatible override semantics.

The port's own copy of diffusesg_tpu/config.py (the port imports nothing of
the JAX package), so both read the same YAML files the same way.

A minimal stand-in for ml_collections.ConfigDict (not a dependency)
reproducing what the reference relies on (reference:
DiffuseSG/utils/arg_parser.py:189-273): YAML -> nested attribute-access dict,
locked after load (new keys rejected unless explicitly unlocked), keyword-wise
CLI overrides applied by (unique) leaf-key name with printed diffs.
"""
from __future__ import annotations

import contextlib
import copy
import logging
from typing import Any, Iterator

import yaml


class ConfigDict:
    """Nested dict with attribute access and a lock against new keys."""

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_fields", {})
        object.__setattr__(self, "_locked", False)
        if data:
            for k, v in data.items():
                self._fields[k] = ConfigDict(v) if isinstance(v, dict) else v

    # -- mapping / attribute protocol -------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return object.__getattribute__(self, "_fields")[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        if self._locked and key not in self._fields:
            raise KeyError(f"config is locked; cannot add new key {key!r}")
        if isinstance(value, dict):
            value = ConfigDict(value)
        self._fields[key] = value

    __getitem__ = __getattr__
    __setitem__ = __setattr__

    def __contains__(self, key: str) -> bool:
        return key in self._fields

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def get(self, key: str, default: Any = None) -> Any:
        return self._fields.get(key, default)

    def keys(self):
        return self._fields.keys()

    def items(self):
        return self._fields.items()

    # -- locking -----------------------------------------------------------
    def lock(self) -> "ConfigDict":
        object.__setattr__(self, "_locked", True)
        for v in self._fields.values():
            if isinstance(v, ConfigDict):
                v.lock()
        return self

    @contextlib.contextmanager
    def unlocked(self):
        states = []

        def _unlock(node):
            states.append((node, node._locked))
            object.__setattr__(node, "_locked", False)
            for v in node._fields.values():
                if isinstance(v, ConfigDict):
                    _unlock(v)

        _unlock(self)
        try:
            yield self
        finally:
            for node, was_locked in states:
                object.__setattr__(node, "_locked", was_locked)

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, ConfigDict) else copy.deepcopy(v)
                for k, v in self._fields.items()}

    def copy(self) -> "ConfigDict":
        out = ConfigDict(self.to_dict())
        if self._locked:
            out.lock()
        return out

    def __repr__(self) -> str:
        return f"ConfigDict({self.to_dict()!r})"

    # -- reference-style keyword overrides -----------------------------------
    def find_paths(self, key: str, _prefix: str = "") -> list[str]:
        """All dotted paths whose final component is ``key``."""
        paths = []
        for k, v in self._fields.items():
            path = f"{_prefix}{k}"
            if k == key:
                paths.append(path)
            if isinstance(v, ConfigDict):
                paths.extend(v.find_paths(key, path + "."))
        return paths

    def get_path(self, dotted: str) -> Any:
        node: Any = self
        for part in dotted.split("."):
            node = node[part]
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: Any = self
        for part in parts[:-1]:
            node = node[part]
        node[parts[-1]] = value

    def override_keyword(self, key: str, value: Any) -> None:
        """Set a (unique) leaf by bare keyword or by dotted path, with a diff log.

        Mirrors the keyword-wise override behavior of the reference
        (arg_parser.py:196-273): a bare name must resolve to exactly one leaf.
        """
        if "." in key:
            paths = [key]
        else:
            paths = self.find_paths(key)
        if not paths:
            raise KeyError(f"override key {key!r} not found in config")
        if len(paths) > 1:
            raise KeyError(f"override key {key!r} is ambiguous: {paths}")
        old = self.get_path(paths[0])
        new = _coerce_like(old, value)
        self.set_path(paths[0], new)
        logging.info("config override: %s: %r -> %r", paths[0], old, new)


def _coerce_like(old: Any, value: Any) -> Any:
    """Parse a CLI string into the type of the existing value."""
    if not isinstance(value, str):
        return value
    if value.lower() in ("null", "none"):
        return None
    if isinstance(old, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(old, int) and not isinstance(old, bool):
        try:
            return int(value)
        except ValueError:
            return float(value)
    if isinstance(old, float):
        return float(value)
    if isinstance(old, (list, ConfigDict)) or old is None:
        return yaml.safe_load(value)
    return value


def load_config(yaml_path: str, overrides: dict[str, Any] | None = None,
                derived: dict[str, Any] | None = None) -> ConfigDict:
    """YAML file -> locked ConfigDict, with overrides and derived flags.

    ``derived`` keys (e.g. flag_sg, logdir) are added under unlocked() the way
    the reference does (arg_parser.py:275-352).
    """
    with open(yaml_path) as f:
        raw = yaml.safe_load(f)
    cfg = ConfigDict(raw).lock()
    if overrides:
        for k, v in overrides.items():
            if v is not None:
                cfg.override_keyword(k, v)
    with cfg.unlocked():
        cfg.flag_sg = any(name in cfg.dataset.name
                          for name in ("visual_genome", "coco_stuff"))
        for k, v in (derived or {}).items():
            cfg.set_path(k, v) if "." in k else setattr(cfg, k, v)
    return cfg


def save_config(cfg: ConfigDict, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f, sort_keys=False)
