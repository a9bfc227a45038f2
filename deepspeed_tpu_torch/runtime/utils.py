"""Runtime utilities: gradient norms and clipping.

Counterpart of the norm helpers of ``deepspeed_tpu/runtime/utils.py``
(reference ``deepspeed/runtime/utils.py`` ``get_grad_norm``,
``clip_grad_norm_``). Both work on a list of tensors, keep the result on the
device (no host sync) and accumulate in fp32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def get_grad_norm(grads: Sequence[torch.Tensor], norm_type: float = 2.0) -> torch.Tensor:
    """Global norm over all tensors (``math.inf`` for the largest absolute
    value), as a 0-d fp32 tensor: each tensor's norm in fp32, then the norm
    of those."""
    norms = torch.stack([torch.linalg.vector_norm(g, norm_type, dtype=torch.float32)
                         for g in grads])
    return torch.linalg.vector_norm(norms, norm_type)


@torch.no_grad()
def clip_grad_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                    norm_type: float = 2.0) -> Tuple[Sequence[torch.Tensor], torch.Tensor]:
    """Scale ``grads`` in place so the global norm is at most ``max_norm``:
    coefficient min(1, max_norm / (norm + 1e-6)). Returns (grads, norm)."""
    total_norm = get_grad_norm(grads, norm_type)
    coef = torch.clamp(max_norm / (total_norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef.to(g.dtype))
    return grads, total_norm
