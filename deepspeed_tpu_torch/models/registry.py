"""Model-family registry: a preset name → (model class, preset table).

Counterpart of ``deepspeed_tpu/models/registry.py`` ``resolve_family``. The
port has the llama, GPT-2, MoE GPT-2 and BERT families; ``gpt2-moe-<size>``
is ``MoEGPT2`` with ``moe_experts`` experts on the ``gpt2-<size>`` preset
(the JAX registry's Switch milestone), at an expert-parallel size of 1 as
there. The other families of the JAX package are later slices. Its
synthetic-batch builders and TPU head relayouts have no counterpart here
(the port runs the canonical presets).
"""

from __future__ import annotations

import functools
import importlib
from typing import Any, Callable, Dict, Tuple

# name prefix → (module of deepspeed_tpu_torch.models, model class)
_FAMILIES = {"llama": ("llama", "LlamaModel"), "bert": ("bert", "BertModel"),
             "gpt2": ("gpt2", "GPT2Model")}


def resolve_family(model_name: str, moe_experts: int = 8) -> Tuple[Callable, Dict[str, Any]]:
    """→ (model_cls, PRESETS) for ``model_name``; for ``gpt2-moe-*`` the
    class is ``MoEGPT2`` bound to ``moe_experts`` experts and the table
    holds the one preset."""
    family = next((f for f in _FAMILIES if model_name.startswith(f)), None)
    if family is None:
        raise NotImplementedError(f"model family of {model_name!r}: later slice of the port")
    module, cls = _FAMILIES[family]
    mod = importlib.import_module(f"deepspeed_tpu_torch.models.{module}")
    if model_name.startswith("gpt2-moe"):
        from deepspeed_tpu_torch.models.gpt2_moe import MoEGPT2

        dense = model_name.replace("-moe", "")
        if dense not in mod.PRESETS:
            raise KeyError(f"unknown gpt2-moe preset {model_name!r}: no {dense!r} in "
                           f"{sorted(mod.PRESETS)}")
        return (functools.partial(MoEGPT2, num_experts=moe_experts, ep_size=1),
                {model_name: mod.PRESETS[dense]})
    if model_name not in mod.PRESETS:
        raise KeyError(f"unknown {family} preset {model_name!r}; have {sorted(mod.PRESETS)}")
    return getattr(mod, cls), mod.PRESETS
