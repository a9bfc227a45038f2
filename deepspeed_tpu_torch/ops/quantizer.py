"""Weight quantization: int8 and int4 with one scale (and zero point) per
group.

Counterpart of ``deepspeed_tpu/ops/quantizer.py`` (reference
``csrc/quantization`` quantize / dequantize and the ``GroupQuantizer`` of
module injection). A weight is stored as int8 codes (or two int4 codes
packed in each byte) with an fp32 scale, and in asymmetric mode an fp32
zero point, per group. The JAX package dequantizes outside any kernel
(XLA fuses it into the matmul's operand read); here dequantization is
plain torch ops, run per module just before it computes
(``inference/engine.py``), into a transient tensor.

Group layout, as in JAX: groups tile the contraction dim (the last but one)
of an ``(..., in, out)`` weight, each group of ``group_size`` input rows
sharing a scale per output column. A group size that does not divide the
dim pads it with zero rows up to the next group boundary; a size at or
above the dim is one group. A 1-D tensor is quantized as one column. The
codes keep the JAX layout, ``(..., n_groups, group_size, out)`` (int4:
``group_size / 2`` rows of packed bytes, row 2i in the low nibble, row
2i + 1 in the high one), and the scales ``(..., n_groups, out)``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import torch


class QuantizedTensor:
    """A quantized weight: ``q`` the int8 codes (packed int4 when
    ``num_bits`` is 4), ``scale`` fp32, ``zero`` fp32 or None (symmetric),
    and the original ``shape`` and ``dtype``."""

    def __init__(self, num_bits: int, q: torch.Tensor, scale: torch.Tensor,
                 zero: Optional[torch.Tensor], shape, dtype: torch.dtype):
        self.num_bits = int(num_bits)
        self.q = q
        self.scale = scale
        self.zero = zero
        self.shape = tuple(shape)
        self.dtype = dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        """Bytes held: the codes, and 4 per scale and zero point."""
        n = self.q.numel() + self.scale.numel() * 4
        if self.zero is not None:
            n += self.zero.numel() * 4
        return n

    def __repr__(self):
        return f"QuantizedTensor(int{self.num_bits}, shape={self.shape}, dtype={self.dtype})"


def quant_group_layout(n_in: int, group_size: int):
    """(group_size, n_groups, padded_in) for an ``n_in``-row contraction
    dim: the dim padded up to a group boundary; a size <= 0 or >= the dim
    is one group of the whole dim."""
    if group_size <= 0 or group_size >= n_in:
        return n_in, 1, n_in
    padded = math.ceil(n_in / group_size) * group_size
    return group_size, padded // group_size, padded


def _group_reshape(w: torch.Tensor, group_size: int):
    """(..., in, out) → (..., n_groups, group_size, out), the ``in`` dim
    zero-padded to a group boundary when needed."""
    *lead, n_in, n_out = w.shape
    group_size, n_groups, padded = quant_group_layout(n_in, group_size)
    if padded != n_in:
        w = torch.cat([w, w.new_zeros(*lead, padded - n_in, n_out)], dim=-2)
    return w.reshape(*lead, n_groups, group_size, n_out), group_size


def quantize_tensor(w: torch.Tensor, num_bits: int = 8, group_size: int = 128,
                    symmetric: bool = True) -> QuantizedTensor:
    """Quantize one ``(..., in, out)`` float tensor. int8 codes lie in
    [-127, 127] and int4 codes in [-7, 7], two packed per byte along the
    group axis (an odd group size is rounded up to even). Asymmetric mode
    centres each group at its zero point (the mid-range)."""
    if num_bits not in (8, 4):
        raise ValueError(f"num_bits {num_bits} not in (8, 4)")
    if num_bits == 4 and group_size % 2:
        group_size += 1
    orig_dtype, orig_shape = w.dtype, tuple(w.shape)
    if w.dim() == 1:
        w = w.reshape(-1, 1)
    g, group_size = _group_reshape(w.float(), group_size)
    qmax = 127.0 if num_bits == 8 else 7.0
    if symmetric:
        scale = g.abs().amax(dim=-2, keepdim=True) / qmax            # (..., G, 1, out)
        zero = None
        q = torch.round(g / torch.clamp(scale, min=1e-12))
    else:
        lo = g.amin(dim=-2, keepdim=True)
        hi = g.amax(dim=-2, keepdim=True)
        scale = (hi - lo) / (2 * qmax)
        zero = (hi + lo) / 2
        q = torch.round((g - zero) / torch.clamp(scale, min=1e-12))
    q = torch.clamp(q, -qmax, qmax).to(torch.int8)
    if num_bits == 4:
        lo4, hi4 = q[..., 0::2, :].to(torch.int16), q[..., 1::2, :].to(torch.int16)
        q = (((hi4 & 0x0F) << 4) | (lo4 & 0x0F)).to(torch.uint8).view(torch.int8)
    return QuantizedTensor(num_bits, q, scale.squeeze(-2),
                           zero.squeeze(-2) if zero is not None else None,
                           orig_shape, orig_dtype)


def _unpack_int4(q: torch.Tensor) -> torch.Tensor:
    """Packed (..., rows, out) bytes → (..., 2 * rows, out) int8 codes,
    each nibble sign-extended; row 2i from the low nibble."""
    u = q.view(torch.uint8)
    lo = (u & 0x0F).to(torch.int8)
    hi = (u >> 4).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=-2).reshape(*q.shape[:-2], q.shape[-2] * 2, q.shape[-1])


def dequantize_tensor(leaf: QuantizedTensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The dense tensor of ``leaf`` in ``dtype`` (its original type when
    None), computed in fp32 as JAX computes it: codes times scale (plus the
    zero point), the group padding stripped."""
    q = _unpack_int4(leaf.q) if leaf.num_bits == 4 else leaf.q
    w = q * leaf.scale[..., None, :]                                  # fp32
    if leaf.zero is not None:
        w = w + leaf.zero[..., None, :]
    n_in = leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[0]
    w = w.reshape(*w.shape[:-3], w.shape[-3] * w.shape[-2], w.shape[-1])
    if w.shape[-2] != n_in:
        w = w.narrow(w.dim() - 2, 0, n_in)
    return w.reshape(leaf.shape).to(dtype or leaf.dtype)


def is_quantized_leaf(x) -> bool:
    return isinstance(x, QuantizedTensor)


DEFAULT_EXCLUDE = ("wte", "wpe", "embed", "ln", "bias")


def _eligible(name: str, t, min_numel: int, exclude) -> bool:
    """A float tensor of two or more dims and at least ``min_numel``
    elements whose name holds none of ``exclude``."""
    if not torch.is_tensor(t) or t.dim() < 2 or not t.is_floating_point():
        return False
    if t.numel() < min_numel:
        return False
    return not any(pat in name for pat in (exclude or ()))


def quantize_params(params: Mapping[str, Any], num_bits: int = 8, group_size: int = 128,
                    symmetric: bool = True, min_numel: int = 1 << 16,
                    exclude=DEFAULT_EXCLUDE, q_groups: Optional[int] = None) -> Dict[str, Any]:
    """A state dict with its large 2-D+ float tensors quantized. Embeddings
    (the tied head included), norms and biases are left as they are by
    default, as in JAX and the reference. ``q_groups`` (groups per tensor)
    overrides ``group_size`` per tensor as ``in_dim // q_groups``."""
    out = {}
    for name, t in params.items():
        if _eligible(name, t, min_numel, exclude):
            gs = group_size if not q_groups else max(1, t.shape[-2] // q_groups)
            out[name] = quantize_tensor(t, num_bits=num_bits, group_size=gs,
                                        symmetric=symmetric)
        else:
            out[name] = t
    return out


def dequantize_params(params: Mapping[str, Any], dtype: Optional[torch.dtype] = None
                      ) -> Dict[str, Any]:
    """The inverse of :func:`quantize_params`; with ``dtype`` every float
    tensor in that type."""
    def one(x):
        if is_quantized_leaf(x):
            return dequantize_tensor(x, dtype)
        if dtype is not None and torch.is_tensor(x) and x.is_floating_point():
            return x.to(dtype)
        return x
    return {name: one(x) for name, x in params.items()}


def quantized_nbytes(params: Mapping[str, Any]) -> int:
    """The bytes of a (partly) quantized state dict."""
    return sum(x.nbytes if is_quantized_leaf(x) else x.numel() * x.element_size()
               for x in params.values() if is_quantized_leaf(x) or torch.is_tensor(x))


class Quantizer:
    """The reference ``ds_quantizer`` surface over these functions: one
    group size per tensor from ``q_groups`` groups."""

    def __init__(self, q_groups: int = 1, num_bits: int = 8, symmetric: bool = True):
        self.q_groups = q_groups
        self.num_bits = num_bits
        self.symmetric = symmetric

    def quantize(self, w: torch.Tensor) -> QuantizedTensor:
        group_dim = w.shape[-2] if w.dim() >= 2 else w.shape[0]
        return quantize_tensor(w, num_bits=self.num_bits,
                               group_size=max(1, group_dim // self.q_groups),
                               symmetric=self.symmetric)

    def dequantize(self, leaf: QuantizedTensor, dtype: Optional[torch.dtype] = None):
        return dequantize_tensor(leaf, dtype)
