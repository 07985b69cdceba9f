"""Configuration system (counterpart of ``papr_tpu/config.py``).

The JAX package's ``__init__`` imports jax, so the port keeps its own copy of
the pure-YAML loader: ``configs/default.yml`` deep-merged with a per-scene
YAML, then wrapped for attribute access. Merge rules are the reference's:

* nested dicts merge recursively;
* the ``test.datasets`` list-of-dicts merges entries by their ``name`` key;
  unmatched entries are cloned from the first default entry and then merged;
* every other value (including non-``datasets`` lists) is overwritten.

The port reads the existing ``tpu.*`` keys with device-aware meanings (see
``papr_tpu_torch/model/papr.py``); it adds no config group of its own.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Mapping

import yaml

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
DEFAULT_CONFIG_PATHS = (
    os.path.join(os.getcwd(), "configs", "default.yml"),
    os.path.join(os.path.dirname(_PKG_DIR), "configs", "default.yml"),
)


class Config(dict):
    """Attribute-access dict; nested dicts come back as ``Config`` views."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __getitem__(self, name):
        value = dict.__getitem__(self, name)
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
        return value

    def __contains__(self, name: object) -> bool:
        return dict.__contains__(self, name)

    def get_path(self, dotted: str, default: Any = None) -> Any:
        """Fetch ``a.b.c`` style paths, returning ``default`` when missing."""
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def merge_config(base: dict, override: Mapping[str, Any]) -> dict:
    """In-place deep merge with the reference's semantics."""
    for key, value in override.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            merge_config(base[key], value)
        elif (isinstance(value, list) and key == "datasets"
              and isinstance(base.get(key), list)):
            for entry in value:
                name = entry["name"]
                for existing in base[key]:
                    if existing.get("name") == name:
                        existing.update(entry)
                        break
                else:
                    new_entry = copy.deepcopy(base[key][0])
                    merge_config(new_entry, entry)
                    base[key].append(new_entry)
        else:
            base[key] = value
    return base


def _find_default_config() -> str:
    for p in DEFAULT_CONFIG_PATHS:
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        "configs/default.yml not found; searched: %s" % (DEFAULT_CONFIG_PATHS,))


def load_config(scene_path: str | None = None,
                default_path: str | None = None,
                overrides: Mapping[str, Any] | None = None) -> Config:
    """Load default.yml, merge the scene YAML and the overrides, and wrap."""
    with open(default_path or _find_default_config(), "r") as f:
        cfg = yaml.safe_load(f)
    if scene_path:
        with open(scene_path, "r") as f:
            scene = yaml.safe_load(f)
        merge_config(cfg, scene or {})
    if overrides:
        merge_config(cfg, overrides)
    return Config(cfg)


def make_eval_config(train_cfg: Config) -> Config:
    """Derive the eval-time config: ``dataset`` updated from ``eval.dataset``
    (reference train.py:351-352)."""
    cfg = copy.deepcopy(dict(train_cfg))
    cfg["dataset"] = dict(cfg["dataset"])
    cfg["dataset"].update(cfg["eval"]["dataset"])
    return Config(cfg)


def make_test_config(cfg: Config, dataset_entry: Mapping[str, Any]) -> Config:
    """Derive a per-test-dataset config (reference test.py:371-376)."""
    out = copy.deepcopy(dict(cfg))
    out["dataset"] = dict(out["dataset"])
    out["dataset"].update(dataset_entry)
    return Config(out)
