"""Decode attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/decode_attention.py``. The kernel
is ``csrc/decode_attention.cu``; it replaces the Pallas ``_decode_kernel``:
one new query token per sequence attends over a KV cache whose entries are
valid through index ``pos``, with grouped-query heads.

A CUDA tensor goes to the kernel, or the call raises. A CPU tensor goes to
the plain version, :func:`decode_reference`, which is also the models'
non-kernel decode path.
"""

from __future__ import annotations

import ctypes
import math

import torch

from deepspeed_tpu_torch.ops.op_builder import CudaKernel

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 96, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("decode_attention", {
    # q, k, v, pos, o, b, h, kv, s, dh, scale, dtype, device, stream
    "decode_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P),
})


def decode_reference(q, k_cache, v_cache, pos):
    """The grouped einsum of ``deepspeed_tpu/models/common.py``
    ``cached_decode_attention``: q (B, H, Dh), caches (B, S, KV, Dh) valid
    through ``pos`` (an int or a 0-d tensor). Scores in the input type, then
    fp32; probabilities cast back to the input type. → (B, H, Dh)."""
    B, H, Dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, Dh)
    scale = 1.0 / math.sqrt(Dh)
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k_cache).float() * scale
    valid = torch.arange(S, device=q.device) <= pos
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bgrk,bkgd->bgrd", p, v_cache).reshape(B, H, Dh)


def _check(q, k_cache, v_cache, pos):
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(f"decode_attention takes float32, bfloat16 or float16 q/k/v of one "
                        f"type, got {q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != q.shape[0] or k_cache.shape[3] != q.shape[2]:
        raise ValueError(f"expected q (B, H, Dh), caches (B, S, KV, Dh); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if q.shape[1] % k_cache.shape[2]:
        raise ValueError(f"query heads {q.shape[1]} not divisible by KV heads "
                         f"{k_cache.shape[2]}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[2]} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if t.device != q.device:
            raise ValueError("q and the caches must lie on one device")
    if pos.device != q.device or pos.dtype != torch.int32 or pos.numel() != 1:
        raise ValueError(f"pos must be one int32 on {q.device}, got "
                         f"{pos.dtype} {tuple(pos.shape)} on {pos.device}")


def decode_attention(q, k_cache, v_cache, pos):
    """q: (B, H, Dh), the new token's queries; k_cache/v_cache: (B, S, KV, Dh)
    with entries valid through index ``pos`` (valid length pos + 1). ``pos``
    is an int or a 0-d int32 tensor on q's device, which the kernel reads
    there. Returns (B, H, Dh)."""
    if q.device.type == "cpu":
        return decode_reference(q, k_cache, v_cache, pos)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA or CPU tensors, not {q.device}")
    if not torch.is_tensor(pos):
        pos = torch.tensor(pos, dtype=torch.int32, device=q.device)
    _check(q, k_cache, v_cache, pos)
    B, H, Dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    o = torch.empty_like(q)
    KERNEL.launch("decode_attention", q.data_ptr(), k_cache.data_ptr(),
                  v_cache.data_ptr(), pos.data_ptr(), o.data_ptr(), B, H, KV, S, Dh,
                  1.0 / math.sqrt(Dh), _DTYPE_CODES[q.dtype], q.device.index,
                  torch.cuda.current_stream(q.device).cuda_stream)
    return o
