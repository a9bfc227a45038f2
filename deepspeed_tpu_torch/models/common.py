"""Shared model building blocks: RoPE, the attention dispatch and the LM loss.

Counterpart of ``deepspeed_tpu/models/common.py`` for what the llama serving
path and the GPT-2 training path use. The attention dispatch has no
fallback: ``use_flash`` / ``use_flash_decode`` choose the kernel wrapper
(which launches the CUDA kernel for a CUDA tensor and runs its plain version
for a CPU tensor), otherwise the plain einsum path runs, as the JAX
package's flags select. Where the JAX dispatch catches a failing flash
kernel and falls back to einsum, the port raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.ops.pallas.decode_attention import decode_attention, decode_reference
from deepspeed_tpu_torch.ops.pallas.flash_attention import flash_attention, mha_reference

# logits-buffer budget: chunk length chosen so the (B, chunk, V) fp32 buffer
# stays around 256MB (the JAX package's value)
_CHUNK_ELEMS = 64 * 1024 * 1024


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


def causal_attention(q, k, v, use_flash: bool = True, sequence_parallel=False):
    """The causal-attention dispatch shared by the model families: the
    single-device branch of the JAX ``causal_attention``. Sequence
    parallelism (ring / Ulysses) is a later slice of the port."""
    if sequence_parallel:
        raise NotImplementedError("sequence parallelism: later slice of the port")
    return local_causal_attention(q, k, v, use_flash)


def parse_lm_batch(batch):
    """dict with input_ids [+ labels/loss_mask] or bare (B, T) tensor →
    (ids, labels, loss_mask)."""
    if isinstance(batch, dict):
        ids = batch["input_ids"]
        return ids, batch.get("labels", ids), batch.get("loss_mask")
    return batch, batch, None


def chunked_lm_loss(x, head, targets, loss_mask=None, bias=None, remat=True):
    """Mean next-token NLL with the vocab projection computed in sequence
    chunks, as the JAX ``chunked_lm_loss`` does (same chunk length).

    x: (B, T, D) final hidden states already shifted to align with
    ``targets`` (B, T); ``head``: (D, V) in compute dtype; ``loss_mask``:
    optional (B, T) weighting. ``remat`` runs each chunk under
    ``torch.utils.checkpoint``, so autograd keeps no chunk's fp32 logits
    and recomputes them in the backward.
    """
    B, T, D = x.shape
    vocab = head.shape[1]
    chunk = max(1, min(T, _CHUNK_ELEMS // max(1, B * vocab)))
    chunk = next((cc for cc in range(chunk, 0, -1) if T % cc == 0), 1)
    targets = targets.long()

    def chunk_nll(xc, tc):
        logits = (xc @ head).float()                                    # (B, C, V)
        if bias is not None:
            logits = logits + bias.float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, tc[..., None])[..., 0]
        return lse - tgt

    nll = []
    for i in range(0, T, chunk):
        xc, tc = x[:, i:i + chunk], targets[:, i:i + chunk]
        nll.append(checkpoint(chunk_nll, xc, tc, use_reentrant=False) if remat
                   else chunk_nll(xc, tc))
    nll = torch.cat(nll, dim=1)                                         # (B, T)
    if loss_mask is not None:
        m = loss_mask.float()
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)
