"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py`` (forward
only; the backward kernels come with the training slice). The kernel is
``csrc/flash_attention_fwd.cu``; it replaces the Pallas ``_fwd_tri_kernel``
and ``_fwd_kernel``.

A CUDA tensor goes to the kernel, or the call raises. A CPU tensor goes to
the plain version, :func:`mha_reference_lse`, which is also what the kernel
is checked against on the card.

Layout: :func:`flash_attention` takes and returns (B, T, H, D), as the JAX
function does; :func:`flash_forward` works on (B*H, T, D) and also returns
the fp32 log-sum-exp per row, kept for the backward.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.op_builder import CudaKernel

NEG_INF = -1e30
HEAD_DIMS = (64, 96, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("flash_attention_fwd", {
    # q, k, v, o, lse, bh, t_q, t_k, d, causal, dtype, device, stream
    "flash_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
})


def mha_reference(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Plain einsum attention on (B, T, H, D), as the JAX ``mha_reference``
    and the models' non-flash path compute it: scores in the input type,
    softmax in fp32, probabilities cast back to the input type."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        mask = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def mha_reference_lse(q, k, v, causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version on (B*H, T, D) with the scale already in
    q: everything in fp32, output cast to q's type. → (o, lse (B*H, T_q))."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        mask = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.exp(s - lse[..., None]), v.float())
    return o.to(q.dtype), lse


def _check(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention_fwd takes float32 or bfloat16 q/k/v of one "
                        f"type, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"expected q (BH, Tq, D), k/v (BH, Tk, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[2]} not in {HEAD_DIMS}")
    if min(q.shape[1], k.shape[1]) < 1:
        raise ValueError("empty sequence")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")


def flash_forward(q, k, v, causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B*H, Tq, D) with the softmax scale folded in; k, v (B*H, Tk, D).
    → (o (B*H, Tq, D) in q's type, lse (B*H, Tq) fp32)."""
    if q.device.type == "cpu":
        return mha_reference_lse(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward runs on CUDA or CPU tensors, not {q.device}")
    _check(q, k, v)
    bh, t_q, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(bh, t_q, dtype=torch.float32, device=q.device)
    KERNEL.launch("flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), lse.data_ptr(), bh, t_q, k.shape[1], d, int(causal),
                  _DTYPE_CODES[q.dtype], q.device.index,
                  torch.cuda.current_stream(q.device).cuda_stream)
    return o, lse


def flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """q, k, v: (B, T, H, D) → (B, T, H, D)."""
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    # the scale is folded into q in q's type, outside the kernel, as in JAX
    q = q * torch.tensor(scale, dtype=q.dtype)
    to_bhtd = lambda x, t: x.transpose(1, 2).reshape(b * h, t, d)
    o, _ = flash_forward(to_bhtd(q, t_q), to_bhtd(k, t_k), to_bhtd(v, t_k), causal)
    return o.reshape(b, h, t_q, d).transpose(1, 2)
