"""Config plumbing: a strict-keys dataclass base.

Counterpart of ``deepspeed_tpu/runtime/config_utils.py``, without pydantic.
A config block is a dataclass built from a ds_config dict by
:meth:`DeepSpeedConfigModel.from_dict`, which accepts each field by its name
or by the alias in its metadata (``field(..., metadata={"alias": "tp"})``),
treats ``None`` and ``"auto"`` as "use the default", builds nested blocks
from dicts, and rejects unknown keys with a did-you-mean hint.
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Any, Mapping, Optional


@dataclasses.dataclass
class DeepSpeedConfigModel:
    """Base for all config blocks."""

    @classmethod
    def from_dict(cls, data: Optional[Mapping[str, Any]] = None, **kwargs):
        data = {k: v for k, v in {**(data or {}), **kwargs}.items()
                if v is not None and not (isinstance(v, str) and v == "auto")}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        aliases = {f.metadata["alias"]: f.name for f in fields.values()
                   if "alias" in f.metadata}
        unknown = set(data) - set(fields) - set(aliases)
        if unknown:
            block = cls.__name__.removesuffix("Config") or cls.__name__
            raise ValueError(f"Unknown key(s) in the {block} config block: "
                             f"{format_unknown_key_hints(unknown, set(fields) | set(aliases))}")
        kw = {}
        for key, value in data.items():
            name = aliases.get(key, key)
            if name in kw:
                raise ValueError(f"{name!r} given twice (by name and by alias)")
            sub = fields[name].default_factory
            if isinstance(value, Mapping) and isinstance(sub, type) \
                    and issubclass(sub, DeepSpeedConfigModel):
                value = sub.from_dict(value)
            kw[name] = value
        return cls(**kw)


def format_unknown_key_hints(unknown, accepted) -> str:
    """``'foo' (did you mean 'for'?), 'bar'``."""
    hints = []
    for k in sorted(unknown):
        close = difflib.get_close_matches(k, list(accepted), n=1)
        hints.append(f"{k!r}" + (f" (did you mean {close[0]!r}?)" if close else ""))
    return ", ".join(hints)
