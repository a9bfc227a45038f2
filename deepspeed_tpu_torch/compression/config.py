"""Compression config: the ds_config ``compression_training`` block.

Counterpart of ``deepspeed_tpu/compression/config.py``, with the same keys,
defaults and bounds, on the port's dataclass base (the card's machine has no
pydantic): ``weight_quantization``, ``activation_quantization``,
``sparse_pruning``, ``row_pruning``, ``head_pruning``, ``channel_pruning``
(each with ``shared_parameters`` and per-group ``different_groups``) and
``layer_reduction``. Unknown keys are rejected with a did-you-mean hint.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


def _bound(block, name: str, lo: float, strict: bool = False, hi: Optional[float] = None):
    value = getattr(block, name)
    if value < lo or (strict and value == lo) or (hi is not None and value > hi):
        rng = f"{'>' if strict else '>='} {lo}" + (f" and <= {hi}" if hi is not None else "")
        raise ValueError(f"{type(block).__name__}.{name} must be {rng}, got {value}")


@dataclasses.dataclass
class QuantSharedParams(DeepSpeedConfigModel):
    enabled: bool = False
    quantizer_kernel: bool = False          # accepted; the fake-quant is plain torch ops
    schedule_offset: int = 0
    quantize_groups: int = 1
    quantize_verbose: bool = False
    quantization_type: str = "symmetric"    # symmetric | asymmetric
    quantize_weight_in_forward: bool = True
    rounding: str = "nearest"               # nearest | stochastic
    fp16_mixed_quantize: Dict = dataclasses.field(default_factory=dict)
    quantization_period: int = 1

    def __post_init__(self):
        _bound(self, "schedule_offset", 0)
        _bound(self, "quantize_groups", 1)
        _bound(self, "quantization_period", 1)


@dataclasses.dataclass
class QuantGroupParams(DeepSpeedConfigModel):
    start_bits: int = 8
    target_bits: int = 8
    quantization_period: Optional[int] = None


@dataclasses.dataclass
class PruneSharedParams(DeepSpeedConfigModel):
    enabled: bool = False
    schedule_offset: int = 1000
    method: str = "l1"                      # l1 | topk

    def __post_init__(self):
        _bound(self, "schedule_offset", 0)


@dataclasses.dataclass
class PruneGroupParams(DeepSpeedConfigModel):
    dense_ratio: float = 0.5
    num_heads: Optional[int] = None         # head_pruning only

    def __post_init__(self):
        _bound(self, "dense_ratio", 0.0, strict=True, hi=1.0)


@dataclasses.dataclass
class CompressionGroup(DeepSpeedConfigModel):
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    modules: List[str] = dataclasses.field(default_factory=lambda: ["*"])
    related_modules: Optional[List[Any]] = None


@dataclasses.dataclass
class TechniqueConfig(DeepSpeedConfigModel):
    shared_parameters: Dict[str, Any] = dataclasses.field(default_factory=dict)
    different_groups: Dict[str, CompressionGroup] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, data: Optional[Mapping[str, Any]] = None, **kwargs):
        out = super().from_dict(data, **kwargs)
        out.different_groups = {name: g if isinstance(g, CompressionGroup)
                                else CompressionGroup.from_dict(g)
                                for name, g in out.different_groups.items()}
        return out


@dataclasses.dataclass
class LayerReductionConfig(DeepSpeedConfigModel):
    enabled: bool = False
    keep_number_layer: Optional[int] = None
    module_name_prefix: str = ""
    teacher_layer: List[int] = dataclasses.field(default_factory=list)
    other_module_name: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CompressionConfig(DeepSpeedConfigModel):
    weight_quantization: TechniqueConfig = dataclasses.field(default_factory=TechniqueConfig)
    activation_quantization: TechniqueConfig = dataclasses.field(
        default_factory=TechniqueConfig)
    sparse_pruning: TechniqueConfig = dataclasses.field(default_factory=TechniqueConfig)
    row_pruning: TechniqueConfig = dataclasses.field(default_factory=TechniqueConfig)
    head_pruning: TechniqueConfig = dataclasses.field(default_factory=TechniqueConfig)
    channel_pruning: TechniqueConfig = dataclasses.field(default_factory=TechniqueConfig)
    layer_reduction: LayerReductionConfig = dataclasses.field(
        default_factory=LayerReductionConfig)

    @classmethod
    def from_ds_config(cls, ds_config) -> "CompressionConfig":
        """Accept either the full ds_config or the compression_training block."""
        block = ds_config.get("compression_training", ds_config) \
            if isinstance(ds_config, Mapping) else {}
        return cls.from_dict(block)
