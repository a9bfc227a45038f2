"""Compression primitives: fake quantization and the pruning masks.

Counterpart of ``deepspeed_tpu/compression/basic_ops.py``. Each technique is
a function ``w -> w'`` on one tensor. The JAX package applies them to its
layer-stacked leaves (a leading L); the port's transform
(``compression/compress.py``) stacks a model's per-layer tensors into the
same (L, ...) view before calling them, so groups, quantiles and head
scores span every layer as they do in JAX.

``fake_quantize`` and the top-k mask application are autograd Functions
with straight-through gradients (the gradient reaches ``w`` unchanged); the
other masks multiply ``w`` by a constant mask, so their gradient is
``g * mask``, as JAX's comparison masks give. The element-wise work here is
plain torch ops on either device: the JAX package's is XLA element-wise
work, not a Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

# the stochastic rounding's integer hash (the low-bias 32-bit finalizer)
_HASH_MUL = (0x7FEB352D, 0x846CA68B)
_GOLDEN = 0x9E3779B9
_MASK32 = 0xFFFFFFFF


def _hash_uniform(n: int, seed: torch.Tensor, device) -> torch.Tensor:
    """``n`` draws uniform on [-0.5, 0.5) from a counter-based hash of each
    element's index and the 0-d int64 ``seed`` (a device tensor: no host
    read)."""
    h = (torch.arange(n, dtype=torch.int64, device=device) + seed * _GOLDEN) & _MASK32
    h = h ^ (h >> 16)
    h = (h * _HASH_MUL[0]) & _MASK32
    h = h ^ (h >> 15)
    h = (h * _HASH_MUL[1]) & _MASK32
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24)) - 0.5


def fake_quantize_values(w: torch.Tensor, num_bits: int, num_groups: int, symmetric: bool,
                         stochastic: bool) -> torch.Tensor:
    """Quantize-dequantize ``w`` (no autograd), computed in fp32 and cast
    back to ``w``'s type. Groups tile the flattened tensor, the last one
    padded with zeros that take part in its range, as in JAX.

    Nearest rounding is JAX's bit for bit (round half to even). Stochastic
    rounding adds noise uniform on [-0.5, 0.5) before the floor, seeded
    from the bit pattern of the scaled values' sum, so it is unbiased and
    changes as the weights change; JAX draws the same distribution from
    its own generator, so the two draws differ."""
    shape, n = w.shape, w.numel()
    g = max(1, min(num_groups, n))
    pad = (-n) % g
    flat = F.pad(w.reshape(-1).float(), (0, pad)).reshape(g, -1)
    qmax = float(2 ** (num_bits - 1) - 1)
    # a device tensor, not a Python number: CUDA divides by a host scalar as
    # a product with its reciprocal, which rounds differently from JAX's
    # division
    div = torch.tensor(qmax if symmetric else 2 * qmax, dtype=torch.float32,
                       device=flat.device)
    if symmetric:
        scale = flat.abs().amax(dim=1, keepdim=True) / div
        zero = 0.0
    else:
        lo = flat.amin(dim=1, keepdim=True)
        hi = flat.amax(dim=1, keepdim=True)
        scale = (hi - lo) / div
        zero = (hi + lo) / 2
    scale = torch.clamp(scale, min=1e-12)
    x = (flat - zero) / scale
    if stochastic:
        seed = x.sum(dtype=torch.float32).view(torch.int32).to(torch.int64)
        noise = _hash_uniform(x.numel(), seed, x.device).view(x.shape)
        q = torch.floor(x + 0.5 + noise)
    else:
        q = torch.round(x)
    q = torch.clamp(q, -qmax, qmax)
    out = (q * scale + zero).reshape(-1)[:n].reshape(shape)
    return out.to(w.dtype)


class _FakeQuantize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, num_bits, num_groups, symmetric, stochastic):
        return fake_quantize_values(w, num_bits, num_groups, symmetric, stochastic)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None, None         # straight-through


def fake_quantize(w: torch.Tensor, num_bits: int, num_groups: int, symmetric: bool,
                  stochastic: bool) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient (the JAX
    ``fake_quantize``; reference SymQuantizer / AsymQuantizer)."""
    return _FakeQuantize.apply(w, num_bits, num_groups, symmetric, stochastic)


# ------------------------------------------------------------------ masks
def _sorted_at(flat: torch.Tensor, idx: Sequence[int]) -> list:
    """The order statistics of ``flat`` at the 0-based indices ``idx``
    (``torch.quantile`` refuses inputs over 2^24 elements; a sort does not)."""
    values = torch.sort(flat).values
    return [values[i] for i in idx]


def quantile(flat: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(flat, q)`` of a 1-D fp32 tensor with its default
    linear interpolation, in its float32 arithmetic: the position
    ``q * (n - 1)``, its floor and ceiling, and the weighted sum of the two
    order statistics. NaN anywhere gives NaN."""
    n = flat.numel()
    q32 = np.float32(q)
    pos = np.float32(q32 * (np.float32(n) - np.float32(1)))
    low, high = np.floor(pos), np.ceil(pos)
    hw = np.float32(pos - low)
    lw = np.float32(np.float32(1) - hw)
    top = np.float32(n) - np.float32(1)
    low, high = int(min(max(low, 0), top)), int(min(max(high, 0), top))
    lv, hv = _sorted_at(flat, (low, high))
    out = lv * float(lw) + hv * float(hw)
    return torch.where(torch.isnan(flat).any(), torch.full_like(out, float("nan")), out)


def topk_mask(scores: torch.Tensor, dense_ratio: float) -> torch.Tensor:
    """1.0 where ``scores`` is in the top ``dense_ratio`` fraction, else 0.0
    (fp32): ``scores >= quantile(scores, 1 - dense_ratio)``, ties kept."""
    thresh = quantile(scores.reshape(-1).float(), 1.0 - dense_ratio)
    return (scores >= thresh).float()


class _SteMask(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, mask):
        return w * mask.to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None                           # straight-through to w


def ste_mask_apply(w: torch.Tensor, dense_ratio: float, scores: torch.Tensor) -> torch.Tensor:
    """``w * topk_mask(scores)`` with a straight-through gradient to ``w``."""
    return _SteMask.apply(w, topk_mask(scores, dense_ratio))


def sparse_mask(w: torch.Tensor, dense_ratio: float) -> torch.Tensor:
    """Unstructured magnitude mask (fp32, ``w``'s shape)."""
    return topk_mask(w.detach().float().abs(), dense_ratio)


def row_mask(w: torch.Tensor, dense_ratio: float) -> torch.Tensor:
    """Row mask of an (..., in, out) weight: score = L1 norm of each input
    row, shape (..., in, 1)."""
    return topk_mask(w.detach().float().abs().sum(dim=-1, keepdim=True), dense_ratio)


def channel_mask(w: torch.Tensor, dense_ratio: float) -> torch.Tensor:
    """Output-channel mask: score = L1 norm of each output column, shape
    (..., 1, out)."""
    return topk_mask(w.detach().float().abs().sum(dim=-2, keepdim=True), dense_ratio)


def head_mask(w: torch.Tensor, num_heads: int, dense_ratio: float) -> torch.Tensor:
    """Head mask of an (..., in, out) attention projection, its output dim
    split into ``num_heads`` heads, scored by L1 norm summed over every
    leading (layer) dim, so all layers share one mask: shape (out,) fp32."""
    *lead, n_in, n_out = w.shape
    if n_out % num_heads:
        raise ValueError(f"head_prune: output dim {n_out} not divisible by {num_heads} heads")
    per = n_out // num_heads
    g = w.detach().float().abs().reshape(*lead, n_in, num_heads, per)
    scores = g.sum(dim=tuple(range(len(lead))) + (-3, -1))
    k = max(1, int(round(num_heads * dense_ratio)))
    thresh = torch.sort(scores).values[-k]
    return (scores >= thresh).float().repeat_interleave(per)


def sparse_prune(w: torch.Tensor, dense_ratio: float, method: str = "l1") -> torch.Tensor:
    """Unstructured magnitude pruning (reference SPARSE_PRUNING): ``l1``
    multiplies by the mask, ``topk`` applies it with a straight-through
    gradient."""
    if method == "topk":
        return ste_mask_apply(w, dense_ratio, w.detach().float().abs())
    return w * sparse_mask(w, dense_ratio).to(w.dtype)


def row_prune(w: torch.Tensor, dense_ratio: float, method: str = "l1") -> torch.Tensor:
    """Structured row pruning (reference ROW_PRUNING)."""
    return w * row_mask(w, dense_ratio).to(w.dtype)


def channel_prune(w: torch.Tensor, dense_ratio: float, method: str = "l1") -> torch.Tensor:
    """Structured output-channel pruning (reference CHANNEL_PRUNING)."""
    return w * channel_mask(w, dense_ratio).to(w.dtype)


def head_prune(w: torch.Tensor, num_heads: int, dense_ratio: float) -> torch.Tensor:
    """Attention-head pruning (reference HEAD_PRUNING): the lowest-L1 heads
    of the output dim zeroed."""
    return w * head_mask(w, num_heads, dense_ratio).to(w.dtype)


def layer_reduce(stacked: torch.Tensor, teacher_layer: Sequence[int]) -> torch.Tensor:
    """A layer-stacked (L, ...) tensor sliced to ``teacher_layer`` (the
    reference's layer-reduction student initialization)."""
    return stacked.index_select(0, torch.as_tensor(list(teacher_layer), dtype=torch.long,
                                                   device=stacked.device))


def prune_mask(kind: str, w: torch.Tensor, ratio: float, num_heads: int = 1) -> torch.Tensor:
    """The mask one pruning technique multiplies ``w`` by, in a shape that
    broadcasts against it: ``kind`` is sparse, row, channel or head."""
    if kind == "head":
        return head_mask(w, num_heads, ratio)
    return {"sparse": sparse_mask, "row": row_mask, "channel": channel_mask}[kind](w, ratio)


__all__ = ["fake_quantize", "fake_quantize_values", "topk_mask", "ste_mask_apply",
           "sparse_prune", "row_prune", "channel_prune", "head_prune", "layer_reduce",
           "quantile", "prune_mask"]
