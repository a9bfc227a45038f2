"""Flash attention: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``. Three CUDA
sources hold the kernels:

- ``csrc/flash_attention_fwd.cu`` replaces the Pallas ``_fwd_tri_kernel``
  and ``_fwd_kernel``; its plain version is :func:`mha_reference_lse`;
- ``csrc/flash_attention_bwd.cu`` replaces ``_bwd_dq_tri_kernel`` and
  ``_bwd_dq_kernel`` (entry ``flash_attention_bwd_dq``, wrapper
  :func:`flash_backward_dq`, plain version
  :func:`mha_backward_dq_reference`) and ``_bwd_dkv_tri_kernel`` and
  ``_bwd_dkv_kernel`` (``flash_attention_bwd_dkv``,
  :func:`flash_backward_dkv`, :func:`mha_backward_dkv_reference`);
- ``csrc/sparse_attention.cu`` replaces the block-sparse
  ``_sparse_fwd_kernel`` (entry ``sparse_attention_fwd``, wrapper
  :func:`sparse_forward`, plain version :func:`sparse_reference_lse`),
  ``_sparse_bwd_dq_kernel`` (``sparse_attention_bwd_dq``,
  :func:`sparse_backward_dq`, :func:`sparse_backward_dq_reference`) and
  ``_sparse_bwd_dkv_kernel`` (``sparse_attention_bwd_dkv``,
  :func:`sparse_backward_dkv`, :func:`sparse_backward_dkv_reference`); the
  forward walks the CSR pair lists of :class:`SparsePairs`, the backward
  kernels its two :class:`SparseSchedule` s.

A CUDA tensor goes to the kernels, or the call raises. A CPU tensor goes to
the plain versions, which are also what the kernels are checked against on
the card.

Layout: :func:`flash_attention` and :func:`flash_attention_sparse` take and
return (B, T, H, D), as the JAX functions do, and are differentiable: each
is a ``torch.autograd.Function`` (:class:`FlashAttentionFunction`,
:class:`SparseAttentionFunction`) whose forward and backward kernels work on
(B*H, T, D) with the softmax scale folded into q. The forward also returns
the fp32 log-sum-exp per row, which the backward uses to recompute the
probabilities.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
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


def _dense_mask(q, k, causal: bool):
    """The causal mask of q against k, or None (every key visible)."""
    return _causal_mask(q.shape[1], k.shape[1], q.device) if causal else None


def _masked_mha(q, k, v, mask, scale: float):
    """Plain einsum attention on (B, T, H, D) with a (Tq, Tk) bool mask of
    visible keys (None: all): scores in the input type, softmax in fp32,
    probabilities cast back to the input type."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def mha_reference(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Plain einsum attention on (B, T, H, D), as the JAX ``mha_reference``
    and the models' non-flash path compute it: scores in the input type,
    softmax in fp32, probabilities cast back to the input type."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _masked_mha(q, k, v, _dense_mask(q, k, causal), scale)


def _reference_lse(q, k, v, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.exp(s - lse[..., None]), v.float())
    return o.to(q.dtype), lse


def mha_reference_lse(q, k, v, causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version on (B*H, T, D) with the scale already in
    q: everything in fp32, output cast to q's type. → (o, lse (B*H, T_q))."""
    return _reference_lse(q, k, v, _dense_mask(q, k, causal))


def _p_ds(q32, k32, v, do32, lse, delta, mask):
    """What ``_bwd_p_ds`` recomputes, in fp32: P = exp(S - lse), exactly
    zero where the (Tq, Tk) ``mask`` hides a key, and dS = P ∘ (dO Vᵀ - Δ)."""
    p = torch.exp(torch.matmul(q32, k32.transpose(1, 2)) - lse[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    return p, p * (torch.matmul(do32, v.float().transpose(1, 2)) - delta[..., None])


def _dq_reference(q, k, v, do, lse, delta, mask):
    k32 = k.float()
    _, ds = _p_ds(q.float(), k32, v, do.float(), lse, delta, mask)
    return torch.matmul(ds, k32).to(q.dtype)


def _dkv_reference(q, k, v, do, lse, delta, mask):
    q32, do32 = q.float(), do.float()
    p, ds = _p_ds(q32, k.float(), v, do32, lse, delta, mask)
    dk = torch.matmul(ds.transpose(1, 2), q32)
    dv = torch.matmul(p.transpose(1, 2), do32)
    return dk.to(k.dtype), dv.to(v.dtype)


def mha_backward_dq_reference(q, k, v, do, lse, delta, causal: bool = True):
    """The dq kernel's plain version: dQ = dS K, in fp32; dq in q's type."""
    return _dq_reference(q, k, v, do, lse, delta, _dense_mask(q, k, causal))


def mha_backward_dkv_reference(q, k, v, do, lse, delta, causal: bool = True):
    """The dkv kernel's plain version: dV = Pᵀ dO, dK = dSᵀ Q, in fp32; dk
    and dv in k's and v's types."""
    return _dkv_reference(q, k, v, do, lse, delta, _dense_mask(q, k, causal))


def mha_backward_reference(q, k, v, do, lse, delta, causal: bool = True):
    """The backward kernels' plain version on (B*H, T, D) with the scale
    already in q: what ``_bwd_p_ds`` computes, all in fp32 —
    P = exp(S - lse), dV = Pᵀ dO, dS = P ∘ (dO Vᵀ - Δ), dQ = dS K,
    dK = dSᵀ Q. ``lse`` and ``delta`` (Δ = rowsum(dO ∘ O)) are (B*H, T_q)
    fp32. Masked pairs contribute exactly zero, so a row that saw no key
    gets zero gradients. → (dq, dk, dv) in q's, k's and v's types."""
    dq = mha_backward_dq_reference(q, k, v, do, lse, delta, causal)
    return (dq, *mha_backward_dkv_reference(q, k, v, do, lse, delta, causal))


def _on_cuda(q, what: str) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor (the
    plain version runs); any other device raises."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {q.device}")
    return True


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
    _check_aligned(q=q, k=k, v=v)


def _check_aligned(**tensors):
    """The kernels stage tiles with 16-byte cp.async copies: each base
    pointer must be 16-byte aligned, which a view with a storage offset can
    break."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (data_ptr "
                             f"{t.data_ptr():#x}, storage offset {t.storage_offset()})")


def flash_forward(q, k, v, causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B*H, Tq, D) with the softmax scale folded in; k, v (B*H, Tk, D).
    → (o (B*H, Tq, D) in q's type, lse (B*H, Tq) fp32)."""
    if not _on_cuda(q, "flash_forward"):
        return mha_reference_lse(q, k, v, causal)
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
    _check_aligned(do=do)
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
    if not _on_cuda(q, "flash_backward"):
        return mha_backward_dq_reference(q, k, v, do, lse, delta, causal)
    _check_bwd(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    BWD_KERNEL.launch("flash_attention_bwd_dq", *_bwd_args(q, k, v, do, lse, delta),
                      dq.data_ptr(), *_bwd_tail(q, k, causal))
    return dq


def flash_backward_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """(dk, dv) of :func:`flash_forward` (the ``flash_attention_bwd_dkv``
    kernel on a CUDA tensor, its plain version on a CPU tensor)."""
    if not _on_cuda(q, "flash_backward"):
        return mha_backward_dkv_reference(q, k, v, do, lse, delta, causal)
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


# ------------------------------------------------------------ block-sparse
# csrc/sparse_attention.cu: the forward of block-sparse attention over the
# CSR pair lists, and dq and dk/dv over the CTA schedules below
SPARSE_BLOCKS = (16, 32, 64, 128)
SPARSE_KERNEL = CudaKernel("sparse_attention", {
    # q, k, v, o, lse, row_ptr, row_cols, bh, t, block, d, causal, dtype, device, stream
    "sparse_attention_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, do, lse, delta, dq, own_rows, chunk_ptr, chunks, n_cta, bh, t, d, causal,
    # dtype, device, stream
    "sparse_attention_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _P),
    # q, k, v, do, lse, delta, dk, dv, own_rows, chunk_ptr, chunks, n_cta, bh, t, d, causal,
    # dtype, device, stream
    "sparse_attention_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _P),
})

CTA_WARPS = 4      # warps of a backward CTA; each owns 16 rows, one mma.m16 tile
CHUNK = 16         # rows of a streamed partner chunk


def _group(lists: np.ndarray, size: int) -> list:
    """Partition the units (rows of ``lists``, a units × partner-blocks bool
    map) into groups of at most ``size`` that share partners: each group is
    seeded by the longest list left (the lowest unit on a tie), then grows
    one unit at a time by the unit that adds the fewest partners to the
    group's union, preferring the longer list, then the nearer unit.
    Deterministic; one pass of n × n products per added unit."""
    n = lists.shape[0]
    if size == 1:
        return [[u] for u in range(n)]
    as_f = lists.astype(np.float32)
    lens = lists.sum(axis=1).astype(np.int64)
    units = np.arange(n)
    left = np.ones(n, dtype=bool)
    groups = []
    for seed in np.argsort(-lens, kind="stable"):
        if not left[seed]:
            continue
        left[seed] = False
        group, union = [int(seed)], lists[seed].copy()
        while len(group) < size and left.any():
            growth = lens - (as_f @ union).astype(np.int64)
            key = (growth * (n + 1) + n - lens) * (n + 1) + np.abs(units - seed)
            pick = int(np.flatnonzero(left)[np.argmin(key[left])])
            left[pick] = False
            group.append(pick)
            union |= lists[pick]
        groups.append(group)
    return groups


class SparseSchedule:
    """Which own rows share a CTA in a sparse backward kernel, and the
    partner rows it streams: one side of a layout.

    ``lists`` is (n, n) bool, row ``i`` the partner blocks of own block
    ``i``: the causal-cut layout for dq (own rows are queries, partners
    keys), its transpose for dk/dv (own keys, partner queries). A CTA owns
    64 rows, 16 per warp. Its own *units* are ``min(block, 64)`` rows each:
    ``group = 64 // unit_rows`` layout blocks at block <= 64, and half a
    block at block 128 (both halves walk the block's list). Units are
    grouped by :func:`_group`, so the units of a CTA share partners.

    Per CTA ``c``:

    - ``units[c]``: its own units (-1 for an empty slot); slot ``s`` holds
      rows ``units[c, s] * unit_rows ..`` and is served by warps
      ``s * unit_rows // 16 ..``;
    - ``partners[ptr[c]:ptr[c + 1]]``: the ascending union of its units'
      partner blocks, and ``masks`` beside it: bit ``s`` set when slot ``s``
      attends that block;
    - what the kernel reads: ``own_rows[c, w]``, the first own row of warp
      ``w`` (-1: none), and ``chunks[chunk_ptr[c]:chunk_ptr[c + 1]]``, one
      int32 per 16-row partner chunk, ``first row | warp mask``, padded with
      zeros (no warp) to a multiple of four chunks (one 64-row tile). A warp
      takes a chunk when its bit is set; under causal a chunk that lies
      wholly past the warp's diagonal (keys after all its queries) carries
      no bit for that warp, and a chunk with no bit is left out.

    CTAs are ordered by their number of chunks, longest first, which is
    the order they launch in. ``useful_share`` is the share of warp-chunk
    slots that do work; ``longest`` the most chunks of one CTA. What the
    kernel reads is copied to ``device`` once, here.
    """

    def __init__(self, lists: np.ndarray, block: int, causal: bool, own_is_query: bool,
                 device):
        n = lists.shape[0]
        self.unit_rows = min(block, 64)
        self.group = 64 // self.unit_rows
        unit_lists = np.repeat(lists, block // self.unit_rows, axis=0)
        groups = _group(unit_lists, self.group)
        slot_of_warp = [w * CHUNK // self.unit_rows for w in range(CTA_WARPS)]

        rows_of = []        # per CTA: the first own row of each warp
        entries = []        # per CTA: (partner blocks, slot masks)
        chunk_lists = []
        for g in groups:
            slots = g + [-1] * (self.group - len(g))
            own = []
            for w, s in enumerate(slot_of_warp):
                first = slots[s] * self.unit_rows + w * CHUNK % self.unit_rows
                own.append(first if slots[s] >= 0 else -1)
            masks = np.zeros(n, dtype=np.int64)
            for s, u in enumerate(g):
                masks[unit_lists[u]] |= 1 << s
            blocks = np.flatnonzero(masks)
            # (entry, chunk) first partner rows, then each warp's bit
            p0 = blocks[:, None] * block + np.arange(0, block, CHUNK)[None, :]
            warps = np.zeros(p0.shape, dtype=np.int64)
            for w, r in enumerate(own):
                if r < 0:
                    continue
                bit = (masks[blocks][:, None] >> slot_of_warp[w]) & 1
                if causal:     # the whole chunk past the warp's diagonal
                    bit = bit & ~((p0 > r) if own_is_query else (p0 < r))
                warps |= bit << w
            chunks = (p0 | warps)[warps > 0].tolist()
            chunks += [0] * (-len(chunks) % CTA_WARPS)
            rows_of.append(own)
            entries.append((blocks, masks[blocks]))
            chunk_lists.append(chunks)

        order = sorted(range(len(groups)), key=lambda c: -len(chunk_lists[c]))
        ptr = lambda sizes: np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
        self.units = np.array([groups[c] + [-1] * (self.group - len(groups[c]))
                               for c in order], dtype=np.int32)
        self.ptr = ptr([len(entries[c][0]) for c in order])
        self.partners = np.concatenate([entries[c][0] for c in order]).astype(np.int32)
        self.masks = np.concatenate([entries[c][1] for c in order]).astype(np.int32)
        self.own_rows_np = np.array([rows_of[c] for c in order], dtype=np.int32)
        self.chunk_ptr_np = ptr([len(chunk_lists[c]) for c in order])
        self.chunks_np = np.array([w for c in order for w in chunk_lists[c]], dtype=np.int32)
        self.n_cta = len(order)
        used = sum(int((self.chunks_np >> w & 1).sum()) for w in range(CTA_WARPS))
        self.useful_share = used / (CTA_WARPS * self.chunks_np.size)
        self.longest = int(np.diff(self.chunk_ptr_np).max())
        dev = lambda a: torch.from_numpy(a).to(device)
        self.own_rows, self.chunk_ptr, self.chunks = (
            dev(self.own_rows_np), dev(self.chunk_ptr_np), dev(self.chunks_np))


class SparsePairs:
    """The block pairs of one layout at one sequence length, on one device.

    The JAX ``_sparse_pairs`` enumerates the kept (query block, key block)
    pairs twice, row-major for the forward and dq and column-major for
    dk/dv, with first/last/valid flags that start and end each run on the
    sequential TPU grid. Here the two orders are CSR lists, and the run
    bounds are the pointers: query block ``i`` attends key blocks
    ``row_cols[row_ptr[i]:row_ptr[i + 1]]`` and key block ``j`` is attended
    by query blocks ``col_rows[col_ptr[j]:col_ptr[j + 1]]``, both ascending.
    A key block no query attends has an empty list (JAX's dummy pair), and
    its dk/dv are written as zeros. Causal drops the pairs above the
    diagonal; a query block left with no key block raises, as in JAX.
    The forward kernel walks the row lists, copied to the device; the
    backward kernels walk ``dq`` and ``dkv``, the :class:`SparseSchedule`
    of each side. The column lists stay on the host.
    """

    def __init__(self, layout, causal: bool, t: int, device):
        lay = np.asarray(layout, dtype=bool).copy()
        n = lay.shape[0]
        if lay.shape != (n, n) or n < 1:
            raise ValueError(f"layout must be a square (n, n) block map, got {lay.shape}")
        if t % n:
            raise ValueError(f"seq {t} not divisible by layout blocks {n}")
        if causal:
            lay &= np.tril(np.ones((n, n), dtype=bool))
        if not lay.any(axis=1).all():
            empty = np.where(~lay.any(axis=1))[0]
            raise ValueError(f"sparse layout leaves query blocks {empty.tolist()} "
                             "with no key blocks (add a local/diagonal pattern)")
        self.layout, self.n, self.block, self.causal = lay, n, t // n, causal
        self.device = torch.device(device)
        ptr = lambda counts: np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        self.row_ptr_np = ptr(lay.sum(axis=1))
        self.row_cols_np = np.nonzero(lay)[1].astype(np.int32)
        self.col_ptr_np = ptr(lay.sum(axis=0))
        self.col_rows_np = np.nonzero(lay.T)[1].astype(np.int32)
        # the lists go to the device once, here, never per call
        to_dev = lambda a: torch.from_numpy(a).to(self.device)
        self.row_ptr, self.row_cols = to_dev(self.row_ptr_np), to_dev(self.row_cols_np)
        self.dq = SparseSchedule(lay, t // n, causal, True, self.device)
        self.dkv = SparseSchedule(lay.T, t // n, causal, False, self.device)
        diag = int(np.trace(lay)) if causal else 0
        b = self.block
        # visible (query, key) token pairs per head: a diagonal block keeps
        # its lower triangle when causal
        self.visible = (int(lay.sum()) - diag) * b * b + diag * b * (b + 1) // 2
        self._mask = None

    @property
    def mask(self) -> torch.Tensor:
        """(T, T) bool, True where the key is visible: the layout's
        token-level expansion, causal-cut when causal."""
        if self._mask is None:
            b = self.block
            m = np.kron(self.layout, np.ones((b, b), dtype=bool))
            if self.causal:
                m &= np.tril(np.ones(m.shape, dtype=bool))
            self._mask = torch.from_numpy(m).to(self.device)
        return self._mask


_PAIRS = {}


def sparse_pairs(layout, causal: bool, t: int, device) -> SparsePairs:
    """The cached :class:`SparsePairs` of (layout, causal, T, device): built
    and copied to the device at the first call only."""
    lay = np.asarray(layout, dtype=bool)
    key = (lay.tobytes(), lay.shape, bool(causal), int(t), str(torch.device(device)))
    if key not in _PAIRS:
        _PAIRS[key] = SparsePairs(lay, bool(causal), t, device)
    return _PAIRS[key]


def sparse_reference_lse(q, k, v, layout, causal: bool = True):
    """The sparse forward kernel's plain version on (B*H, T, D) with the
    scale in q: the dense plain math under the layout's token-level mask, in
    fp32; o in q's type. → (o, lse (B*H, T) fp32)."""
    return _reference_lse(q, k, v, sparse_pairs(layout, causal, q.shape[1], q.device).mask)


def sparse_backward_dq_reference(q, k, v, do, lse, delta, layout, causal: bool = True):
    """The sparse dq kernel's plain version: dQ = dS K under the layout's
    mask, in fp32; dq in q's type."""
    return _dq_reference(q, k, v, do, lse, delta,
                         sparse_pairs(layout, causal, q.shape[1], q.device).mask)


def sparse_backward_dkv_reference(q, k, v, do, lse, delta, layout, causal: bool = True):
    """The sparse dk/dv kernel's plain version: dV = Pᵀ dO, dK = dSᵀ Q under
    the layout's mask, in fp32; a key no query sees gets exactly zero."""
    return _dkv_reference(q, k, v, do, lse, delta,
                          sparse_pairs(layout, causal, q.shape[1], q.device).mask)


def sparse_mha_reference(q, k, v, layout, causal: bool = True, scale: Optional[float] = None):
    """Dense attention on (B, T, H, D) under the token-level expansion of a
    block layout, as the JAX ``sparse_mha_reference`` computes it: scores in
    the input type, softmax in fp32, probabilities cast back."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _masked_mha(q, k, v, sparse_pairs(layout, causal, q.shape[1], q.device).mask, scale)


def _sparse_check(q, k, v, pairs: SparsePairs):
    _check(q, k, v)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"sparse attention is self-attention: q has {q.shape[1]} rows, "
                         f"k {k.shape[1]}")
    if pairs.block not in SPARSE_BLOCKS:
        raise ValueError(f"layout block {pairs.block} (T {q.shape[1]} / {pairs.n} blocks) "
                         f"not in {SPARSE_BLOCKS}")


def _sparse_tail(q, pairs: SparsePairs):
    return (q.shape[0], q.shape[1], pairs.block, q.shape[2], int(pairs.causal),
            _DTYPE_CODES[q.dtype], q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)


def _schedule_args(q, pairs: SparsePairs, sched: SparseSchedule):
    return (sched.own_rows.data_ptr(), sched.chunk_ptr.data_ptr(), sched.chunks.data_ptr(),
            sched.n_cta, q.shape[0], q.shape[1], q.shape[2], int(pairs.causal),
            _DTYPE_CODES[q.dtype], q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)


def sparse_forward(q, k, v, layout, causal: bool = True):
    """Block-sparse attention on (B*H, T, D) with the softmax scale in q (the
    ``sparse_attention_fwd`` kernel on a CUDA tensor, its plain version on a
    CPU tensor). → (o (B*H, T, D) in q's type, lse (B*H, T) fp32)."""
    pairs = sparse_pairs(layout, causal, q.shape[1], q.device)
    if not _on_cuda(q, "sparse_forward"):
        return sparse_reference_lse(q, k, v, layout, causal)
    _sparse_check(q, k, v, pairs)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    SPARSE_KERNEL.launch("sparse_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), lse.data_ptr(), pairs.row_ptr.data_ptr(),
                         pairs.row_cols.data_ptr(), *_sparse_tail(q, pairs))
    return o, lse


def sparse_backward_dq(q, k, v, do, lse, delta, layout, causal: bool = True):
    """dq of :func:`sparse_forward` (the ``sparse_attention_bwd_dq`` kernel on
    a CUDA tensor, its plain version on a CPU tensor). q, k, v, do
    (B*H, T, D); lse and delta = rowsum(dO ∘ O) (B*H, T) fp32."""
    pairs = sparse_pairs(layout, causal, q.shape[1], q.device)
    if not _on_cuda(q, "sparse_backward_dq"):
        return sparse_backward_dq_reference(q, k, v, do, lse, delta, layout, causal)
    _sparse_check(q, k, v, pairs)
    _check_bwd(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    SPARSE_KERNEL.launch("sparse_attention_bwd_dq", *_bwd_args(q, k, v, do, lse, delta),
                         dq.data_ptr(), *_schedule_args(q, pairs, pairs.dq))
    return dq


def sparse_backward_dkv(q, k, v, do, lse, delta, layout, causal: bool = True):
    """(dk, dv) of :func:`sparse_forward` (the ``sparse_attention_bwd_dkv``
    kernel on a CUDA tensor, its plain version on a CPU tensor)."""
    pairs = sparse_pairs(layout, causal, q.shape[1], q.device)
    if not _on_cuda(q, "sparse_backward_dkv"):
        return sparse_backward_dkv_reference(q, k, v, do, lse, delta, layout, causal)
    _sparse_check(q, k, v, pairs)
    _check_bwd(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    SPARSE_KERNEL.launch("sparse_attention_bwd_dkv", *_bwd_args(q, k, v, do, lse, delta),
                         dk.data_ptr(), dv.data_ptr(), *_schedule_args(q, pairs, pairs.dkv))
    return dk, dv


class SparseAttentionFunction(torch.autograd.Function):
    """Block-sparse attention on (B*H, T, D) with the scale in q: forward
    :func:`sparse_forward`, backward :func:`sparse_backward_dq` and
    :func:`sparse_backward_dkv`; it saves q, k, v, o and lse, as the JAX
    ``_sparse_bhtd_fwd`` does, and takes Δ = rowsum(dO ∘ O) in fp32 outside
    the kernels, as ``_sparse_backward`` does."""

    @staticmethod
    def forward(ctx, q, k, v, layout, causal: bool):
        o, lse = sparse_forward(q, k, v, layout, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.layout, ctx.causal = layout, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = sparse_backward_dq(q, k, v, do, lse, delta, ctx.layout, ctx.causal)
        dk, dv = sparse_backward_dkv(q, k, v, do, lse, delta, ctx.layout, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_sparse(q, k, v, layout, causal: bool = True,
                           scale: Optional[float] = None):
    """Block-sparse flash attention: q, k, v (B, T, H, D) → (B, T, H, D),
    ``layout`` an (n, n) 0/1 block map with block size T // n.
    Differentiable."""
    b, t, h, d = q.shape
    n = np.asarray(layout).shape[0]
    if t % n:
        raise ValueError(f"seq {t} not divisible by layout blocks {n}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    # the scale is folded into q in q's type, as in JAX; autograd scales dq back
    q = q * torch.tensor(scale, dtype=q.dtype)
    to_bhtd = lambda x: x.transpose(1, 2).reshape(b * h, t, d)
    o = SparseAttentionFunction.apply(to_bhtd(q), to_bhtd(k), to_bhtd(v),
                                      np.asarray(layout, dtype=bool), bool(causal))
    return o.reshape(b, h, t, d).transpose(1, 2)
