"""Shared model building blocks: RoPE and the attention dispatch.

Counterpart of ``deepspeed_tpu/models/common.py`` for what the llama serving
path uses. The attention dispatch has no fallback: ``use_flash`` /
``use_flash_decode`` choose the kernel wrapper (which launches the CUDA
kernel for a CUDA tensor and runs its plain version for a CPU tensor),
otherwise the plain einsum path runs, as the JAX package's flags select.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from deepspeed_tpu_torch.ops.pallas.decode_attention import decode_attention, decode_reference
from deepspeed_tpu_torch.ops.pallas.flash_attention import flash_attention, mha_reference


def _scaled_inv_freq(inv_freq, scaling: Optional[dict]):
    """Apply HF-style rope_scaling to the frequency vector."""
    if not scaling:
        return inv_freq
    kind = scaling.get("rope_type", scaling.get("type", "default"))
    if kind == "default":
        return inv_freq
    factor = float(scaling["factor"])
    if kind == "linear":
        return inv_freq / factor
    # "llama3": low-frequency components divided by `factor`, high-frequency
    # kept, smooth interpolation in between (transformers'
    # _compute_llama3_parameters)
    low = float(scaling["low_freq_factor"])
    high = float(scaling["high_freq_factor"])
    old_len = float(scaling["original_max_position_embeddings"])
    wavelen = 2.0 * math.pi / inv_freq
    smooth = (old_len / wavelen - low) / (high - low)
    smoothed = (1.0 - smooth) / factor * inv_freq + smooth * inv_freq
    scaled = torch.where(wavelen > old_len / low, inv_freq / factor, inv_freq)
    is_medium = (wavelen >= old_len / high) & (wavelen <= old_len / low)
    return torch.where(is_medium, smoothed, scaled)


def _rope_cos_sin(positions, head_dim: int, theta: float, scaling: Optional[dict] = None):
    """cos/sin tables (T, Dh) for RoPE in the rotate-half convention
    (LLaMA/NeoX), fp32, on ``positions``' device."""
    d2 = head_dim // 2
    exponent = torch.arange(d2, dtype=torch.float32, device=positions.device) / d2
    inv_freq = _scaled_inv_freq(1.0 / (theta ** exponent), scaling)
    ang = positions.float()[:, None] * inv_freq[None, :]   # (T, d2)
    cos = torch.cat([torch.cos(ang)] * 2, dim=-1)
    sin = torch.cat([torch.sin(ang)] * 2, dim=-1)
    return cos, sin


def apply_rope(x, cos, sin):
    """x: (B, T, H, Dh); cos/sin: (T, Dh). Computed in fp32, cast back."""
    x32 = x.float()
    h1, h2 = x32.chunk(2, dim=-1)
    rotated = torch.cat([-h2, h1], dim=-1)
    out = x32 * cos[None, :, None, :] + rotated * sin[None, :, None, :]
    return out.to(x.dtype)


def local_causal_attention(q, k, v, use_flash: bool = True):
    """Causal self-attention on (B, T, H, Dh) with equal head counts: the
    flash kernel when ``use_flash``, else the plain einsum."""
    if use_flash:
        return flash_attention(q, k, v, causal=True)
    return mha_reference(q, k, v, causal=True)


def cached_decode_attention(q, k_cache, v_cache, pos, use_flash_decode: bool = False):
    """Single-token decode attention over a KV cache. q: (B, H, Dh); caches
    (B, S, KV, Dh) valid through index ``pos``; KV may divide H (GQA).
    ``use_flash_decode`` selects the decode kernel, else the grouped einsum.
    → (B, H, Dh)."""
    if use_flash_decode:
        return decode_attention(q, k_cache, v_cache, pos)
    return decode_reference(q, k_cache, v_cache, pos)
