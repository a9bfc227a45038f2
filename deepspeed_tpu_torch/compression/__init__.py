"""Compression training: quantization-aware training (MoQ's staged bit
annealing), pruning and layer reduction, driven by the ds_config
``compression_training`` block. Counterpart of
``deepspeed_tpu/compression/``."""

from deepspeed_tpu_torch.compression.basic_ops import (channel_prune, fake_quantize,
                                                       head_prune, layer_reduce, row_prune,
                                                       sparse_prune, topk_mask)
from deepspeed_tpu_torch.compression.compress import (CompressionTransform, init_compression,
                                                      redundancy_clean, student_initialization)
from deepspeed_tpu_torch.compression.config import CompressionConfig

__all__ = ["CompressionConfig", "CompressionTransform", "init_compression",
           "redundancy_clean", "student_initialization", "fake_quantize",
           "sparse_prune", "row_prune", "channel_prune", "head_prune",
           "layer_reduce", "topk_mask"]
