"""Flash attention: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py`` (dense
attention; the block-sparse kernels come with a later slice). Two CUDA
sources hold the kernels:

- ``csrc/flash_attention_fwd.cu`` replaces the Pallas ``_fwd_tri_kernel``
  and ``_fwd_kernel``; its plain version is :func:`mha_reference_lse`;
- ``csrc/flash_attention_bwd.cu`` replaces ``_bwd_dq_tri_kernel`` and
  ``_bwd_dq_kernel`` (entry ``flash_attention_bwd_dq``, wrapper
  :func:`flash_backward_dq`, plain version
  :func:`mha_backward_dq_reference`) and ``_bwd_dkv_tri_kernel`` and
  ``_bwd_dkv_kernel`` (``flash_attention_bwd_dkv``,
  :func:`flash_backward_dkv`, :func:`mha_backward_dkv_reference`).

A CUDA tensor goes to the kernels, or the call raises. A CPU tensor goes to
the plain versions, which are also what the kernels are checked against on
the card.

Layout: :func:`flash_attention` takes and returns (B, T, H, D), as the JAX
function does, and is differentiable: a ``torch.autograd.Function`` whose
forward is :func:`flash_forward` and whose backward is
:func:`flash_backward`, both on (B*H, T, D) with the softmax scale folded
into q. The forward also returns the fp32 log-sum-exp per row, which the
backward uses to recompute the probabilities.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.op_builder import CudaKernel

NEG_INF = -1e30
HEAD_DIMS = (64, 96, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("flash_attention_fwd", {
    # q, k, v, o, lse, bh, t_q, t_k, d, causal, dtype, device, stream
    "flash_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
})
BWD_KERNEL = CudaKernel("flash_attention_bwd", {
    # q, k, v, do, lse, delta, dq, bh, t_q, t_k, d, causal, dtype, device, stream
    "flash_attention_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, do, lse, delta, dk, dv, bh, t_q, t_k, d, causal, dtype, device, stream
    "flash_attention_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _P),
})


def _causal_mask(t_q: int, t_k: int, device) -> torch.Tensor:
    """(t_q, t_k) bool, True where key j is visible to query i (j <= i)."""
    return torch.ones(t_q, t_k, dtype=torch.bool, device=device).tril()


def mha_reference(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Plain einsum attention on (B, T, H, D), as the JAX ``mha_reference``
    and the models' non-flash path compute it: scores in the input type,
    softmax in fp32, probabilities cast back to the input type."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        logits = logits.masked_fill(~_causal_mask(q.shape[1], k.shape[1], q.device), NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def mha_reference_lse(q, k, v, causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version on (B*H, T, D) with the scale already in
    q: everything in fp32, output cast to q's type. → (o, lse (B*H, T_q))."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    if causal:
        s = s.masked_fill(~_causal_mask(q.shape[1], k.shape[1], q.device), NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.exp(s - lse[..., None]), v.float())
    return o.to(q.dtype), lse


def _p_ds(q32, k32, v, do32, lse, delta, causal: bool):
    """What ``_bwd_p_ds`` recomputes, in fp32: P = exp(S - lse), exactly
    zero where the mask hides a key, and dS = P ∘ (dO Vᵀ - Δ)."""
    p = torch.exp(torch.matmul(q32, k32.transpose(1, 2)) - lse[..., None])
    if causal:
        p = torch.where(_causal_mask(q32.shape[1], k32.shape[1], q32.device), p, 0.0)
    return p, p * (torch.matmul(do32, v.float().transpose(1, 2)) - delta[..., None])


def mha_backward_dq_reference(q, k, v, do, lse, delta, causal: bool = True):
    """The dq kernel's plain version: dQ = dS K, in fp32; dq in q's type."""
    k32 = k.float()
    _, ds = _p_ds(q.float(), k32, v, do.float(), lse, delta, causal)
    return torch.matmul(ds, k32).to(q.dtype)


def mha_backward_dkv_reference(q, k, v, do, lse, delta, causal: bool = True):
    """The dkv kernel's plain version: dV = Pᵀ dO, dK = dSᵀ Q, in fp32; dk
    and dv in k's and v's types."""
    q32, do32 = q.float(), do.float()
    p, ds = _p_ds(q32, k.float(), v, do32, lse, delta, causal)
    dk = torch.matmul(ds.transpose(1, 2), q32)
    dv = torch.matmul(p.transpose(1, 2), do32)
    return dk.to(k.dtype), dv.to(v.dtype)


def mha_backward_reference(q, k, v, do, lse, delta, causal: bool = True):
    """The backward kernels' plain version on (B*H, T, D) with the scale
    already in q: what ``_bwd_p_ds`` computes, all in fp32 —
    P = exp(S - lse), dV = Pᵀ dO, dS = P ∘ (dO Vᵀ - Δ), dQ = dS K,
    dK = dSᵀ Q. ``lse`` and ``delta`` (Δ = rowsum(dO ∘ O)) are (B*H, T_q)
    fp32. Masked pairs contribute exactly zero, so a row that saw no key
    gets zero gradients. → (dq, dk, dv) in q's, k's and v's types."""
    dq = mha_backward_dq_reference(q, k, v, do, lse, delta, causal)
    return (dq, *mha_backward_dkv_reference(q, k, v, do, lse, delta, causal))


def _check(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash attention takes float32, bfloat16 or float16 q/k/v of one "
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


def _check_bwd(q, k, v, do, lse, delta):
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError(f"do must be contiguous and match q {tuple(q.shape)} {q.dtype}; "
                         f"got {tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:2] or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{name} must be contiguous fp32 of shape {tuple(q.shape[:2])} "
                             f"on {q.device}")


def _bwd_args(q, k, v, do, lse, delta):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr())


def _bwd_tail(q, k, causal):
    return (q.shape[0], q.shape[1], k.shape[1], q.shape[2], int(causal), _DTYPE_CODES[q.dtype],
            q.device.index, torch.cuda.current_stream(q.device).cuda_stream)


def flash_backward_dq(q, k, v, do, lse, delta, causal: bool = True):
    """dq of :func:`flash_forward` (the ``flash_attention_bwd_dq`` kernel on
    a CUDA tensor, its plain version on a CPU tensor). q, k, v, do
    (B*H, T, D); lse and delta = rowsum(dO ∘ O) (B*H, Tq) fp32."""
    if q.device.type == "cpu":
        return mha_backward_dq_reference(q, k, v, do, lse, delta, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_backward runs on CUDA or CPU tensors, not {q.device}")
    _check_bwd(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    BWD_KERNEL.launch("flash_attention_bwd_dq", *_bwd_args(q, k, v, do, lse, delta),
                      dq.data_ptr(), *_bwd_tail(q, k, causal))
    return dq


def flash_backward_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """(dk, dv) of :func:`flash_forward` (the ``flash_attention_bwd_dkv``
    kernel on a CUDA tensor, its plain version on a CPU tensor)."""
    if q.device.type == "cpu":
        return mha_backward_dkv_reference(q, k, v, do, lse, delta, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_backward runs on CUDA or CPU tensors, not {q.device}")
    _check_bwd(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    BWD_KERNEL.launch("flash_attention_bwd_dkv", *_bwd_args(q, k, v, do, lse, delta),
                      dk.data_ptr(), dv.data_ptr(), *_bwd_tail(q, k, causal))
    return dk, dv


def flash_backward(q, k, v, o, lse, do, causal: bool = True):
    """The gradients of :func:`flash_forward`: q, k, v, o, do (B*H, T, D)
    with the scale folded into q, lse (B*H, Tq) fp32 from the forward.
    Δ = rowsum(dO ∘ O) is taken here in fp32, outside the kernels, as the
    JAX ``_flash_backward`` does. → (dq, dk, dv) in the inputs' types."""
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = flash_backward_dq(q, k, v, do, lse, delta, causal)
    return (dq, *flash_backward_dkv(q, k, v, do, lse, delta, causal))


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention on (B*H, T, D) with the scale in q: forward
    :func:`flash_forward`, backward :func:`flash_backward`; it saves q, k, v,
    o and lse, as the JAX ``_flash_bhtd_fwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do.contiguous(), ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """q, k, v: (B, T, H, D) → (B, T, H, D). Differentiable."""
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    # the scale is folded into q in q's type, outside the kernels, as in JAX;
    # autograd scales dq back
    q = q * torch.tensor(scale, dtype=q.dtype)
    to_bhtd = lambda x, t: x.transpose(1, 2).reshape(b * h, t, d)
    o = FlashAttentionFunction.apply(to_bhtd(q, t_q), to_bhtd(k, t_k), to_bhtd(v, t_k), causal)
    return o.reshape(b, h, t_q, d).transpose(1, 2)
