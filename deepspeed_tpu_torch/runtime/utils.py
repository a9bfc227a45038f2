"""Runtime utilities: gradient norms and clipping, memory reports, layer
partitions.

Counterpart of ``deepspeed_tpu/runtime/utils.py`` (reference
``deepspeed/runtime/utils.py``). ``get_grad_norm`` and ``clip_grad_norm_``
work on a list of tensors, keep the result on the device (no host sync) and
accumulate in fp32. Given a process ``group``, the tensors are this rank's
partition of the gradients (ZeRO stages 1–3): the global norm is an
all-reduce of the partitions' sums of powers (of their maxima for the
inf-norm). ``see_memory_usage`` reads the card's allocator and the host's
memory; ``partition_uniform`` and ``partition_balanced`` split layers into
contiguous parts. The JAX ``PartitionedTensor`` is a mesh type, which comes
with pipeline parallelism.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.ops.optimizers import Optimizer
from deepspeed_tpu_torch.utils.logging import log_dist


class DummyState(NamedTuple):
    count: int


def DummyOptim(params=None) -> Optimizer:
    """Placeholder optimizer (reference ``utils.py`` ``DummyOptim``) for
    clients that run their own update: it keeps only a step count and
    leaves the parameters as they are. ``params`` is the reference's
    argument and changes nothing."""
    return Optimizer(init=lambda ps: DummyState(count=0),
                     update=lambda grads, state, ps, lr=None, **flat:
                     state._replace(count=state.count + 1))


def _meminfo() -> Dict[str, int]:
    """``/proc/meminfo``'s fields in bytes (empty where it is missing)."""
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                key, _, rest = line.partition(":")
                parts = rest.split()
                if parts:
                    out[key] = int(parts[0]) * (1024 if parts[1:] == ["kB"] else 1)
    except OSError:
        pass
    return out


def see_memory_usage(message: str, force: bool = False) -> None:
    """Log the card's memory (``torch.cuda.memory_allocated``,
    ``max_memory_allocated`` and ``memory_reserved`` of each visible card)
    and the host's used and total memory, on rank 0; nothing unless
    ``force``, as in JAX and the reference."""
    if not force:
        return
    gb = 2 ** 30
    lines = [message]
    if torch.cuda.is_available():
        for d in range(torch.cuda.device_count()):
            lines.append(f"  cuda:{d}: {torch.cuda.memory_allocated(d) / gb:.2f}GB allocated, "
                         f"{torch.cuda.max_memory_allocated(d) / gb:.2f}GB max allocated, "
                         f"{torch.cuda.memory_reserved(d) / gb:.2f}GB reserved")
    else:
        lines.append("  (no CUDA device)")
    info = _meminfo()
    if "MemTotal" in info and "MemAvailable" in info:
        used, total = info["MemTotal"] - info["MemAvailable"], info["MemTotal"]
        lines.append(f"  host: {used / gb:.2f}GB used / {total / gb:.2f}GB "
                     f"({100.0 * used / total:.1f}%)")
    log_dist("\n".join(lines), ranks=[0])


def memory_status(msg: str = "", reset_max: bool = False) -> None:
    """The reference's ``memory_status``: :func:`see_memory_usage`, then
    the card's peak statistics reset when ``reset_max``."""
    see_memory_usage(msg or "memory_status", force=True)
    if reset_max and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def empty_cache() -> None:
    """Release the caching allocator's unused blocks (``torch.cuda.empty_cache``)."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def get_global_norm(norm_list: Sequence[float]) -> float:
    """The square root of the sum of squares of ``norm_list``."""
    return math.sqrt(sum(float(n) ** 2 for n in norm_list))


def partition_uniform(num_items: int, num_parts: int) -> List[int]:
    """The ``num_parts + 1`` boundaries of a uniform split, the first
    ``num_items % num_parts`` parts one longer."""
    parts = [0] * (num_parts + 1)
    chunk, residual = divmod(num_items, num_parts)
    for p in range(num_parts):
        parts[p + 1] = parts[p] + chunk + (1 if p < residual else 0)
    return parts


def partition_balanced(weights: Sequence[float], num_parts: int) -> List[int]:
    """The boundaries of a contiguous split of ``weights`` into
    ``num_parts``: a part ends once the prefix sum reaches the next multiple
    of the mean part weight (the JAX package's greedy split)."""
    target = sum(weights) / num_parts
    bounds = [0]
    acc = 0.0
    for i, w in enumerate(weights):
        acc += w
        if acc >= target * len(bounds) and len(bounds) < num_parts:
            bounds.append(i + 1)
    while len(bounds) < num_parts:
        bounds.append(len(weights))
    bounds.append(len(weights))
    return bounds


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
