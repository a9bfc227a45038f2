"""Model-family registry: a preset name → (model class, preset table).

Counterpart of ``deepspeed_tpu/models/registry.py`` ``resolve_family``. The
port serves the llama family so far; the JAX registry's synthetic-batch
builders and TPU head relayouts have no counterpart here (the port runs the
canonical presets).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple


def resolve_family(model_name: str) -> Tuple[Callable, Dict[str, Any]]:
    """→ (model_cls, PRESETS) for ``model_name``."""
    if model_name.startswith("llama"):
        from deepspeed_tpu_torch.models.llama import PRESETS, LlamaModel

        if model_name not in PRESETS:
            raise KeyError(f"unknown llama preset {model_name!r}; have {sorted(PRESETS)}")
        return LlamaModel, PRESETS
    raise NotImplementedError(f"model family of {model_name!r}: later slice of the port")
