"""Decode attention: the CUDA kernel's wrapper and its plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/decode_attention.py``. The kernel
is ``csrc/decode_attention.cu``; it replaces the Pallas ``_decode_kernel``:
one new query token per sequence attends over a KV cache whose entries are
valid through index ``pos``, with grouped-query heads. The kernel splits the
cache into chunks of :func:`decode_chunk` keys, one CTA each, and the last
CTA of each (batch row, head group) merges the chunks' partial softmax
states; :func:`decode_split_reference` is that split in plain PyTorch.

A CUDA tensor goes to the kernel, or the call raises. A CPU tensor goes to
the plain version, :func:`decode_reference`, which is also the models'
non-kernel decode path.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.op_builder import CudaKernel

NEG_INF = -1e30
# GPT-J-6B serves at 256
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("decode_attention", {
    # q, k, v, pos, o, work, sem, b, h, kv, s, dh, chunk, scale, dtype, device, stream
    "decode_attention": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                         _I, _I, _P),
})
TILE_KEYS = 64       # the kernel's K/V tile; a chunk is a multiple of it
# The grid the chunk length aims for: at least one CTA per SM, so between one
# and two. On the H100 more and shorter chunks were slower at every shape
# measured (PERF.md, section 6): each costs a partial and its share of the merge.
CTAS_PER_SM = 1
# Per device, the merge's semaphores: zero before and after every launch.
# They grow by replacement; a replaced buffer stays alive for the CUDA graphs
# captured with it. Launches on one device must not overlap in time (one
# stream, as the engine runs them).
_SEMAPHORES: dict = {}
_RETIRED: list = []


def decode_chunk(batch: int, kv_heads: int, capacity: int, n_sm: int) -> int:
    """Keys per CTA of the split decode kernel: the longest power-of-two
    multiple of the 64-key tile that still gives the grid ``CTAS_PER_SM``
    CTAs per SM over (batch row, KV head, chunk), or the whole cache when it
    has no more. It depends on the cache capacity S, never on ``pos``, so one
    launch can be captured and replayed at every position; chunks past
    ``pos`` exit at once."""
    chunk = TILE_KEYS
    while chunk < capacity and \
            batch * kv_heads * -(-capacity // (2 * chunk)) >= CTAS_PER_SM * n_sm:
        chunk *= 2
    return chunk


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _semaphores(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 semaphores on ``device``, made outside any
    CUDA graph capture (a decode loop's warm-up step makes them)."""
    sem = _SEMAPHORES.get(device.index)
    if sem is None or sem.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_attention: run it once at this shape before capturing "
                               "a CUDA graph, so that its semaphores exist")
        if sem is not None:
            _RETIRED.append(sem)
        sem = _SEMAPHORES[device.index] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                                      device=device)
    return sem


def decode_reference(q, k_cache, v_cache, pos, alibi=None, window=None):
    """The grouped einsum of ``deepspeed_tpu/models/common.py``
    ``cached_decode_attention``: q (B, H, Dh), caches (B, S, KV, Dh) valid
    through ``pos`` (an int or a 0-d tensor). Scores in the input type, then
    fp32; probabilities cast back to the input type. ``alibi``: optional
    (H,) fp32 slopes, the bias ``slopes[h] * j`` on cache slot j;
    ``window``: GPT-Neo's local window, the slots j > pos - window (None or
    <= 0: every slot through ``pos``). Both read ``pos`` on the device, so a
    captured step stays valid at every position. → (B, H, Dh)."""
    B, H, Dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, Dh)
    scale = 1.0 / math.sqrt(Dh)
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k_cache).float() * scale
    slots = torch.arange(S, device=q.device)
    if alibi is not None:
        s = s + (alibi.to(device=q.device, dtype=torch.float32).reshape(KV, H // KV)[None, :, :, None]
                 * slots.float())
    valid = slots <= pos
    if window is not None and window > 0:
        valid = valid & (slots > pos - window)
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bgrk,bkgd->bgrd", p, v_cache).reshape(B, H, Dh)


def decode_split_reference(q, k_cache, v_cache, pos, chunk: int):
    """The kernel's split in plain PyTorch, fp32: partial softmax states (m,
    l, unnormalised output) per chunk of ``chunk`` keys, entries past ``pos``
    masked to -1e30 and their V rows zeroed (never read), then the merge
    o = sum_c e^(m_c - M) o_c / sum_c e^(m_c - M) l_c. A chunk past ``pos``
    has m = -1e30 and l = 0, and so exactly zero weight. → (B, H, Dh) in
    q's type."""
    B, H, Dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    n = -(-S // chunk)
    pad = n * chunk - S
    valid = torch.arange(n * chunk, device=q.device) <= pos                   # (n * chunk,)
    k = F.pad(k_cache.float(), (0, 0, 0, 0, 0, pad))
    v = F.pad(v_cache.float(), (0, 0, 0, 0, 0, pad)).masked_fill(~valid[:, None, None], 0.0)
    qg = q.float().reshape(B, KV, H // KV, Dh)
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k) / math.sqrt(Dh)
    s = s.masked_fill(~valid, NEG_INF).reshape(B, KV, H // KV, n, chunk)
    m = s.amax(dim=-1)                                                        # (B, KV, r, n)
    p = torch.exp(s - m[..., None]).masked_fill(~valid.reshape(n, chunk), 0.0)
    part_o = torch.einsum("bgrnk,bnkgd->bgrnd", p, v.reshape(B, n, chunk, KV, Dh))
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))
    o = (w[..., None] * part_o).sum(dim=3) / (w * p.sum(dim=-1)).sum(dim=-1)[..., None]
    return o.reshape(B, H, Dh).to(q.dtype)


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
    chunk = decode_chunk(B, KV, S, _sm_count(q.device.index))
    n_chunks = -(-S // chunk)
    o = torch.empty_like(q)
    work, sem = None, None
    if n_chunks > 1:
        # the chunks' partials, sized from S: (B * H, chunks, Dh) outputs, then (m, l)
        work = torch.empty(B * H * n_chunks * (Dh + 2), dtype=torch.float32, device=q.device)
        sem = _semaphores(q.device, B * H).data_ptr()   # one per (batch row, head group)
    KERNEL.launch("decode_attention", q.data_ptr(), k_cache.data_ptr(),
                  v_cache.data_ptr(), pos.data_ptr(), o.data_ptr(),
                  work.data_ptr() if work is not None else None, sem, B, H, KV, S, Dh, chunk,
                  1.0 / math.sqrt(Dh), _DTYPE_CODES[q.dtype], q.device.index,
                  torch.cuda.current_stream(q.device).cuda_stream)
    return o
