"""Small shared helpers."""

import os


def env_flag(name: str) -> bool:
    """A boolean environment knob: unset, empty, "0", "false", "no" and
    "off" are off (the JAX package's ``utils.env_flag``)."""
    return os.environ.get(name, "").strip().lower() not in ("", "0", "false", "no", "off")
