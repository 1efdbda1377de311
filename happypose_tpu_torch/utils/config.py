"""Structured config with `key=value` CLI overrides.

Parity target: the reference's OmegaConf structured configs + CLI override
syntax (megapose/training/training_config.py:44-145, `key=value` overrides
documented in docs/book/megapose/evaluate.md) — implemented over plain
dataclasses: `apply_overrides(cfg, ["lr=1e-4", "render_size=[120,160]"])`
parses values with json and dataclasses.replace's nested dotted paths.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Sequence, TypeVar

T = TypeVar("T")


def _parse_value(raw: str) -> Any:
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw  # bare string


def apply_overrides(cfg: T, overrides: Sequence[str]) -> T:
    """Return a copy of dataclass `cfg` with dotted key=value overrides."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov!r}")
        key, raw = ov.split("=", 1)
        value = _parse_value(raw)
        parts = key.split(".")

        def rec(obj, parts):
            name = parts[0]
            if not hasattr(obj, name):
                raise AttributeError(
                    f"unknown config field {name!r} on {type(obj).__name__}"
                )
            if len(parts) == 1:
                field_type = {
                    f.name: f.type for f in dataclasses.fields(obj)
                }.get(name)
                v = value
                if isinstance(v, list):
                    v = tuple(v) if "Tuple" in str(field_type) else v
                return dataclasses.replace(obj, **{name: v})
            return dataclasses.replace(
                obj, **{name: rec(getattr(obj, name), parts[1:])}
            )

        cfg = rec(cfg, parts)
    return cfg


def config_to_dict(cfg: Any) -> dict:
    """Nested dataclass -> plain dict (for saving with checkpoints)."""
    if dataclasses.is_dataclass(cfg):
        return {
            f.name: config_to_dict(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)
        }
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(config_to_dict(x) for x in cfg)
    return cfg
