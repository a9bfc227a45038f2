"""Inference configuration.

Counterpart of ``deepspeed_tpu/inference/config.py``, key-compatible with it
(and so with the reference's ``deepspeed/inference/config.py``): the same
keys and aliases (``kernel_inject``, ``tp``, ``tm``, ``max_tokens``,
``min_tokens``, ``ckpt_config``, ``injection_dict``), unknown keys rejected.
``checkpoint`` (a training save dir or tag dir) with ``checkpoint_config``
``{"tag": ...}`` serves a training tag; with ``checkpoint_config`` ``{"type":
"Megatron" | "Megatron-MoE", "n_head": N}`` it is a Megatron-DeepSpeed
layer-file directory, which ``init_inference`` reads (``megatron_type``). The
``moe`` block is read with ``ep_size`` 1 (a MoE model served in one
process). ``dtype`` int8 is weight-only quantized serving: the compute runs
in bf16, and with ``quant.enabled`` and ``quant.weight.enabled`` the
engine stores the eligible weights as int8 or int4 codes with group scales
(``quant.weight``: ``num_bits``, ``q_type``, ``q_groups``,
``quantized_initialization.min_numel``); the ``quant`` block's
``activation`` and ``qkv`` parts parse and change nothing, as in JAX.
Blocks this slice does not serve yet (tensor parallelism, expert
parallelism, injection policies) raise ``NotImplementedError`` rather than
being ignored. ``enable_cuda_graph`` is
accepted, as the JAX package accepts it: the engine runs the decode loop as
one captured CUDA graph on the card whatever the key says, as the JAX engine
always compiles it into one program.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import Any, Optional

import torch

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel
from deepspeed_tpu_torch.utils.logging import logger

_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "float16": torch.float16, "fp16": torch.float16, "half": torch.float16,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def _later(what: str):
    return NotImplementedError(f"{what}: later slice of the port")


@dataclasses.dataclass
class DeepSpeedTPConfig(DeepSpeedConfigModel):
    enabled: bool = True
    tp_size: int = 1
    mpu: Any = None
    tp_group: Any = None

    def __post_init__(self):
        if self.tp_size < 1:
            raise ValueError(f"tp_size must be >= 1, got {self.tp_size}")
        if self.tp_size > 1:
            raise _later("tensor parallelism (tp_size > 1)")


@dataclasses.dataclass
class DeepSpeedMoEConfig(DeepSpeedConfigModel):
    enabled: bool = True
    ep_size: int = 1
    moe_experts: list = field(default_factory=lambda: [1])
    type: str = "standard"

    def __post_init__(self):
        if self.ep_size < 1:
            raise ValueError(f"moe.ep_size must be >= 1, got {self.ep_size}")
        if self.enabled and self.ep_size > 1:
            raise _later("expert-parallel serving (moe.ep_size > 1)")


@dataclasses.dataclass
class BaseQuantConfig(DeepSpeedConfigModel):
    enabled: bool = True
    num_bits: int = 8
    q_type: str = "symmetric"          # or "asymmetric"
    q_groups: int = 1


@dataclasses.dataclass
class WeightQuantConfig(BaseQuantConfig):
    quantized_initialization: dict = field(default_factory=dict)
    post_init_quant: dict = field(default_factory=dict)


@dataclasses.dataclass
class ActivationQuantConfig(BaseQuantConfig):
    pass


@dataclasses.dataclass
class QKVQuantConfig(DeepSpeedConfigModel):
    enabled: bool = True


@dataclasses.dataclass
class QuantizationConfig(DeepSpeedConfigModel):
    enabled: bool = True
    activation: ActivationQuantConfig = field(default_factory=ActivationQuantConfig)
    weight: WeightQuantConfig = field(default_factory=WeightQuantConfig)
    qkv: QKVQuantConfig = field(default_factory=QKVQuantConfig)


@dataclasses.dataclass
class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    replace_with_kernel_inject: bool = field(default=False, metadata={"alias": "kernel_inject"})
    dtype: str = "bfloat16"
    tensor_parallel: DeepSpeedTPConfig = field(default_factory=DeepSpeedTPConfig,
                                               metadata={"alias": "tp"})
    enable_cuda_graph: bool = False  # accepted; the decode loop is always graphed on the card
    use_triton: bool = False
    zero: dict = field(default_factory=dict)
    triangular_masking: bool = field(default=True, metadata={"alias": "tm"})
    moe: DeepSpeedMoEConfig = field(default_factory=DeepSpeedMoEConfig)
    quant: QuantizationConfig = field(default_factory=QuantizationConfig)
    checkpoint: Optional[str] = None
    base_dir: str = ""
    set_empty_params: bool = False
    save_mp_checkpoint_path: Optional[str] = None
    checkpoint_config: dict = field(default_factory=dict, metadata={"alias": "ckpt_config"})
    return_tuple: bool = True
    training_mp_size: int = 1
    replace_method: str = "auto"
    injection_policy: Optional[dict] = field(default=None, metadata={"alias": "injection_dict"})
    injection_policy_tuple: Optional[tuple] = None
    config: Optional[dict] = None
    max_out_tokens: int = field(default=1024, metadata={"alias": "max_tokens"})
    min_out_tokens: int = field(default=1, metadata={"alias": "min_tokens"})
    transposed_mode: bool = False
    mp_size: int = 1  # deprecated: becomes tensor_parallel.tp_size

    def __post_init__(self):
        if self.mp_size != 1:
            logger.warning("Config parameter mp_size is deprecated. Use tensor_parallel instead.")
            self.tensor_parallel = DeepSpeedTPConfig(tp_size=self.mp_size)
        for key in ("injection_policy", "injection_policy_tuple"):
            if getattr(self, key):
                raise _later(f"inference config {key!r}")
        self.torch_dtype()

    @property
    def megatron_type(self) -> Optional[str]:
        """The Megatron kind that ``checkpoint_config.type`` names, with case,
        "-" and "_" ignored as in JAX: "megatron" or "megatronmoe"; else
        None."""
        kind = str(self.checkpoint_config.get("type", "")).lower().replace("-", "")
        kind = kind.replace("_", "")
        return kind if kind in ("megatron", "megatronmoe") else None

    @property
    def ep_size(self) -> int:
        return self.moe.ep_size if self.moe.enabled else 1

    @property
    def tp_size(self) -> int:
        return self.tensor_parallel.tp_size

    @property
    def quantize_weights(self) -> bool:
        """``dtype`` int8: weight-only quantized serving."""
        return str(self.dtype).replace("torch.", "") == "int8"

    def torch_dtype(self) -> torch.dtype:
        """The compute type: bf16 for ``dtype`` int8."""
        name = str(self.dtype).replace("torch.", "")
        if name == "int8":
            return torch.bfloat16
        if name not in _DTYPES:
            raise ValueError(f"dtype {self.dtype!r} not one of {sorted(_DTYPES)}")
        return _DTYPES[name]
