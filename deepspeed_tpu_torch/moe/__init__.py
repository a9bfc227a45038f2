"""Mixture of Experts: gate, experts, dispatch and the MoE layer."""

from deepspeed_tpu_torch.moe.experts import Experts  # noqa: F401
from deepspeed_tpu_torch.moe.layer import MoE  # noqa: F401
from deepspeed_tpu_torch.moe.sharded_moe import (MOELayer, TopKGate, top1gating,  # noqa: F401
                                                 top2gating)

__all__ = ["MoE", "Experts", "MOELayer", "TopKGate", "top1gating", "top2gating"]
