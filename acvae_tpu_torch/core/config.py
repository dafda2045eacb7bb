"""YAML config + CLI overrides (counterpart of ``acvae_tpu/core/config.py:20-98``).

``train config.yaml --key=value``: any override replaces the YAML's value,
dotted keys reach into nested mappings (``--ss_args.ss_mode=linear``), and
override strings are read as YAML (``--augments=[timewarp,timemask]`` is a
list).  The YAML is read with the port's own reader (``core/miniyaml.py``),
which gives what ``yaml.safe_load`` gives on the configs' subset.
"""
from __future__ import annotations

import re
from typing import Any, Mapping

from acvae_tpu_torch.core.miniyaml import safe_load


class Config(dict):
    """dict with attribute access and dotted get/set."""

    def __getattr__(self, key: str) -> Any:
        try:
            v = self[key]
        except KeyError as e:
            raise AttributeError(key) from e
        if isinstance(v, dict) and not isinstance(v, Config):
            # stored back so that writes through attribute access persist
            v = Config(v)
            self[key] = v
        return v

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def get_path(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = {}
                node[part] = nxt
            node = nxt
        node[parts[-1]] = value


def _coerce(value: Any) -> Any:
    """A CLI string read as YAML; left a string where it is not YAML the
    reader takes."""
    if not isinstance(value, str):
        return value
    try:
        return safe_load(value)
    except ValueError:
        return value


_YAML11_FLOAT = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _fix_yaml11_floats(node: Any) -> Any:
    """YAML 1.1 reads ``1e-3`` as a string (it wants ``1.0e-3``); turn
    exactly that shape, bare scientific notation, into a float."""
    if isinstance(node, dict):
        return {k: _fix_yaml11_floats(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_fix_yaml11_floats(v) for v in node]
    if isinstance(node, str) and _YAML11_FLOAT.match(node):
        return float(node)
    return node


def load_config(config_file: str | None = None, **overrides) -> Config:
    """Read the YAML, then apply the overrides (dotted keys reach nested
    mappings)."""
    cfg = Config()
    if config_file is not None:
        with open(config_file) as f:
            loaded = safe_load(f) or {}
        if not isinstance(loaded, dict):
            raise ValueError(f"{config_file} must contain a YAML mapping")
        cfg.update(_fix_yaml11_floats(loaded))
    for key, value in overrides.items():
        cfg.set_path(key, _fix_yaml11_floats(_coerce(value)))
    return cfg
