"""Runtime utilities: gradient norms and clipping.

Counterpart of the norm helpers of ``deepspeed_tpu/runtime/utils.py``
(reference ``deepspeed/runtime/utils.py`` ``get_grad_norm``,
``clip_grad_norm_``). Both work on a list of tensors, keep the result on the
device (no host sync) and accumulate in fp32. Given a process ``group``,
the tensors are this rank's partition of the gradients (ZeRO stages 1–3):
the global norm is an all-reduce of the partitions' sums of powers (of
their maxima for the inf-norm).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from deepspeed_tpu_torch import comm


def get_grad_norm(grads: Sequence[torch.Tensor], norm_type: float = 2.0,
                  group=None) -> torch.Tensor:
    """Global norm over all tensors (``math.inf`` for the largest absolute
    value), as a 0-d fp32 tensor: each tensor's norm in fp32, then the norm
    of those; over ``group``'s partitions when one is given."""
    norms = torch.stack([torch.linalg.vector_norm(g, norm_type, dtype=torch.float32)
                         for g in grads])
    if group is None:
        return torch.linalg.vector_norm(norms, norm_type)
    if norm_type == math.inf:
        return comm.all_reduce(norms.max(), op=comm.ReduceOp.MAX, group=group)
    total = comm.all_reduce(norms.pow(norm_type).sum(), group=group)
    return total.pow(1.0 / norm_type)


@torch.no_grad()
def clip_grad_norm_(grads: Sequence[torch.Tensor], max_norm: float, norm_type: float = 2.0,
                    group=None) -> Tuple[Sequence[torch.Tensor], torch.Tensor]:
    """Scale ``grads`` in place so the global norm is at most ``max_norm``:
    coefficient min(1, max_norm / (norm + 1e-6)). Returns (grads, norm)."""
    total_norm = get_grad_norm(grads, norm_type, group)
    coef = torch.clamp(max_norm / (total_norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef.to(g.dtype))
    return grads, total_norm
