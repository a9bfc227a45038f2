"""Inference configuration.

Counterpart of ``deepspeed_tpu/inference/config.py``, key-compatible with it
(and so with the reference's ``deepspeed/inference/config.py``): the same
keys and aliases (``kernel_inject``, ``tp``, ``tm``, ``max_tokens``,
``min_tokens``, ``ckpt_config``, ``injection_dict``), unknown keys rejected.
Blocks this slice does not serve yet (tensor parallelism, MoE, weight
quantization, checkpoint loading, injection policies) raise
``NotImplementedError`` rather than being ignored. ``enable_cuda_graph`` is
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
class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    replace_with_kernel_inject: bool = field(default=False, metadata={"alias": "kernel_inject"})
    dtype: str = "bfloat16"
    tensor_parallel: DeepSpeedTPConfig = field(default_factory=DeepSpeedTPConfig,
                                               metadata={"alias": "tp"})
    enable_cuda_graph: bool = False  # accepted; the decode loop is always graphed on the card
    use_triton: bool = False
    zero: dict = field(default_factory=dict)
    triangular_masking: bool = field(default=True, metadata={"alias": "tm"})
    moe: dict = field(default_factory=dict)
    quant: dict = field(default_factory=dict)
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
        for key in ("moe", "quant", "checkpoint", "injection_policy", "injection_policy_tuple"):
            if getattr(self, key):
                raise _later(f"inference config {key!r}")
        self.torch_dtype()

    @property
    def tp_size(self) -> int:
        return self.tensor_parallel.tp_size

    def torch_dtype(self) -> torch.dtype:
        name = str(self.dtype).replace("torch.", "")
        if name == "int8":
            raise _later("int8 weight-quantized serving")
        if name not in _DTYPES:
            raise ValueError(f"dtype {self.dtype!r} not one of {sorted(_DTYPES)}")
        return _DTYPES[name]
