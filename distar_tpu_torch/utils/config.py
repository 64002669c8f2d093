"""Config cascade: an attribute-access dict and the reference's
``deep_merge_dicts`` semantics (nested dicts merge key by key, any non-dict
override wins wholesale), so the JAX package's model configs load
unchanged."""
from __future__ import annotations

import copy
import json
from typing import Any, Dict, Mapping


class Config(dict):
    """A dict with attribute access, recursively applied."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Mapping) and not isinstance(value, Config):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return type(value)(Config._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, Config._wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> Dict[str, Any]:
        return _unwrap(self)


def _unwrap(value: Any) -> Any:
    if isinstance(value, Mapping):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_unwrap(v) for v in value)
    return value


def deep_merge_dicts(base: Mapping, override: Mapping) -> Config:
    """Return a new Config = base overridden by ``override``, recursively."""
    out = Config(copy.deepcopy(dict(base)))
    for k, v in override.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), Mapping):
            out[k] = deep_merge_dicts(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def read_config(spec: str) -> dict:
    """A launcher's ``--config``: an inline JSON object, a JSON file or a
    YAML file."""
    if spec.lstrip().startswith("{"):
        return json.loads(spec)
    with open(spec) as f:
        if spec.endswith(".json"):
            return json.load(f)
        import yaml

        return yaml.safe_load(f) or {}
