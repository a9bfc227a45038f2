"""Activation checkpointing (the ds_config ``activation_checkpointing``
block): ``checkpointing.configure`` and ``checkpointing.checkpoint``."""

from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing  # noqa: F401
