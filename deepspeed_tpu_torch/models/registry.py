"""Model-family registry: a preset name → (model class, preset table).

Counterpart of ``deepspeed_tpu/models/registry.py`` ``resolve_family``. The
port has the llama, GPT-2 and BERT families so far; ``gpt2-moe-*`` is a
later slice. The JAX registry's synthetic-batch builders and TPU head
relayouts have no counterpart here (the port runs the canonical presets).
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Tuple

# name prefix → (module of deepspeed_tpu_torch.models, model class)
_FAMILIES = {"llama": ("llama", "LlamaModel"), "bert": ("bert", "BertModel"),
             "gpt2": ("gpt2", "GPT2Model")}


def resolve_family(model_name: str) -> Tuple[Callable, Dict[str, Any]]:
    """→ (model_cls, PRESETS) for ``model_name``."""
    family = next((f for f in _FAMILIES if model_name.startswith(f)), None)
    if family is None or model_name.startswith("gpt2-moe"):
        raise NotImplementedError(f"model family of {model_name!r}: later slice of the port")
    module, cls = _FAMILIES[family]
    mod = importlib.import_module(f"deepspeed_tpu_torch.models.{module}")
    if model_name not in mod.PRESETS:
        raise KeyError(f"unknown {family} preset {model_name!r}; have {sorted(mod.PRESETS)}")
    return getattr(mod, cls), mod.PRESETS
