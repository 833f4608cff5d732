"""Typed config tree with YAML + override loading.

The reference scatters configuration across three layers — per-script
argparse flags, ``--params_file`` YAML, and hardcoded in-code constants
(machine-specific basepaths, mesh lookup tables, time-step schedules; see
SURVEY.md §5 "Config / flag system").  Here every model's configuration is
one frozen dataclass (RxnDiff1DConfig, EDL1DConfig, SternConfig,
Pore3DConfig) and this module provides uniform serialization:

    cfg = load_config(Pore3DConfig, "run.yaml", {"voltage_multiplier": -5})
    dump_config(cfg, "run.yaml")

Nested solver dataclasses (NewtonConfig/LinearConfig) map to nested YAML
mappings; unknown keys raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Type, TypeVar

T = TypeVar("T")


def _is_dc(t) -> bool:
    return dataclasses.is_dataclass(t) and isinstance(t, type)


def _build(cls: Type[T], data: Dict[str, Any]) -> T:
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(
            f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name, value in data.items():
        # resolve nested dataclass fields by inspecting the default
        default = fields[name].default_factory() \
            if fields[name].default_factory is not dataclasses.MISSING \
            else fields[name].default
        if dataclasses.is_dataclass(default) and isinstance(value, dict):
            kwargs[name] = dataclasses.replace(default, **value)
        else:
            kwargs[name] = tuple(value) if isinstance(value, list) else value
    return cls(**kwargs)


def load_config(
    cls: Type[T],
    yaml_path: Optional[str] = None,
    overrides: Optional[Dict[str, Any]] = None,
) -> T:
    """Build a model config from a YAML file plus override dict (overrides
    win; either may be None)."""
    data: Dict[str, Any] = {}
    if yaml_path is not None:
        import yaml

        with open(yaml_path) as f:
            data.update(yaml.safe_load(f) or {})
    if overrides:
        for k, v in overrides.items():
            if isinstance(v, dict) and isinstance(data.get(k), dict):
                data[k].update(v)
            else:
                data[k] = v
    return _build(cls, data)


def dump_config(cfg, yaml_path: Optional[str] = None) -> Dict[str, Any]:
    """Serialize a config dataclass to a plain dict (and optionally YAML)."""
    def clean(v):
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {f.name: clean(getattr(v, f.name))
                    for f in dataclasses.fields(v)}
        if isinstance(v, tuple):
            return list(v)
        return v

    d = clean(cfg)
    # drop non-serializable parameter-set objects
    d.pop("params", None)
    if yaml_path is not None:
        import yaml

        with open(yaml_path, "w") as f:
            yaml.safe_dump(d, f, sort_keys=False)
    return d
