"""Megatron-DeepSpeed checkpoints: the 2D (tp × pp) grid's reshaping and
the GPT and MoE GPT readers. Counterpart of ``deepspeed_tpu/checkpoint``."""

from deepspeed_tpu_torch.checkpoint.meg_2d import meg_2d_parallel_map, reshape_meg_2d_parallel
from deepspeed_tpu_torch.checkpoint.megatron_checkpoint import (DeepSpeedCheckpoint,
                                                                load_megatron_gpt,
                                                                load_megatron_moe)

__all__ = ["meg_2d_parallel_map", "reshape_meg_2d_parallel",
           "DeepSpeedCheckpoint", "load_megatron_gpt", "load_megatron_moe"]
