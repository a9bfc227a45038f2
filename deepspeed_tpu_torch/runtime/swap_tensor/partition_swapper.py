"""Tensor ↔ NVMe swapping over the aio handle.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor/partition_swapper.py``
(the reference's ``async_swapper.py`` ``AsyncTensorSwapper`` and the
partitioned swappers' roles): named CPU tensors spill to files in a swap
folder and stream back on demand, with async reads so the next window's
state loads while the current one computes.

Buffers are uint8 CPU tensors whose address is a multiple of 4096 bytes and
whose length is rounded up to one, and each file is written at that rounded
length, so every read and write goes around the page cache (``O_DIRECT``)
where the filesystem takes it. A file holds one tensor's raw bytes; the
swapper's manifest keeps its shape and dtype. Released buffers are kept in a
pool (up to ``POOL_BUFFERS``) and reused for tensors of the same rounded
size, so a step does not fault fresh host pages in for every read.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.aio import DIRECT_ALIGN, AsyncIOHandle, host_zeros

POOL_BUFFERS = 32


def _round_up(n: int) -> int:
    return max(DIRECT_ALIGN, -(-n // DIRECT_ALIGN) * DIRECT_ALIGN)


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


class SwapBuffer:
    """An aligned host buffer holding one swapped tensor's bytes."""

    def __init__(self, nbytes: int):
        self.nbytes = _round_up(nbytes)
        self.data = host_zeros(self.nbytes)

    def view(self, shape, dtype) -> torch.Tensor:
        return self.data[:_nbytes(shape, dtype)].view(dtype).view(shape)


class AsyncTensorSwapper:
    """Spill and restore named CPU tensors in a swap folder with async I/O.

    * ``swap_out(name, tensor, async_op=True)``: copy into an owned aligned
      buffer and write it; the caller's tensor is free at once.
    * ``swap_in(name, async_op=True)``: start reading; ``retrieve(name)``
      waits for it and returns a view of the buffer.
    * ``release(name)``: the buffer back to the pool (the file stays).
    """

    def __init__(self, swap_folder: str, aio_config: Optional[dict] = None):
        os.makedirs(swap_folder, exist_ok=True)
        self.swap_folder = swap_folder
        cfg = dict(aio_config or {})
        self.handle = AsyncIOHandle(
            block_size=cfg.get("block_size", 1 << 20), queue_depth=cfg.get("queue_depth", 32),
            single_submit=cfg.get("single_submit", False),
            overlap_events=cfg.get("overlap_events", True),
            thread_count=cfg.get("thread_count", 8))
        self._manifest: Dict[str, Tuple[tuple, torch.dtype]] = {}
        self._buffers: Dict[str, SwapBuffer] = {}
        self._pool: List[SwapBuffer] = []
        self._pending: Dict[str, str] = {}       # name -> "r" | "w"
        self._lock = threading.Lock()
        self._swap_out_bytes = 0
        self._swap_in_bytes = 0

    def _path(self, name: str) -> str:
        # the name flattened, and a digest of it: 'a.b' and 'a/b' stay apart
        safe = name.replace("/", "_").replace(".", "_")
        digest = hashlib.sha1(name.encode()).hexdigest()[:8]
        return os.path.join(self.swap_folder, f"{safe}.{digest}.swp")

    def _buffer_for(self, name: str, nbytes: int) -> SwapBuffer:
        """``name``'s buffer, from the pool or new; under the lock."""
        buf = self._buffers.get(name)
        if buf is not None and buf.nbytes == _round_up(nbytes):
            return buf
        want = _round_up(nbytes)
        hit = next((i for i, b in enumerate(self._pool) if b.nbytes == want), None)
        buf = self._pool.pop(hit) if hit is not None else SwapBuffer(want)
        self._buffers[name] = buf
        return buf

    # ------------------------------------------------------------------ out
    def swap_out(self, name: str, tensor: torch.Tensor, async_op: bool = True) -> None:
        tensor = tensor.detach()
        with self._lock:
            nbytes = tensor.numel() * tensor.element_size()
            buf = self._buffer_for(name, nbytes)
            buf.view(tuple(tensor.shape), tensor.dtype).copy_(tensor)
            buf.data[nbytes:].zero_()
            self._manifest[name] = (tuple(tensor.shape), tensor.dtype)
            self._pending[name] = "w"
            self._swap_out_bytes += buf.nbytes
        self.handle.async_pwrite(buf.data, self._path(name))
        if not async_op:
            self.synchronize()

    # ------------------------------------------------------------------- in
    def swap_in(self, name: str, async_op: bool = True) -> None:
        with self._lock:
            if name not in self._manifest:
                raise KeyError(f"no swapped tensor named {name!r}")
            buf = self._buffer_for(name, _nbytes(*self._manifest[name]))
            self._pending[name] = "r"
            self._swap_in_bytes += buf.nbytes
        self.handle.async_pread(buf.data, self._path(name))
        if not async_op:
            self.synchronize()

    def retrieve(self, name: str) -> torch.Tensor:
        """The swapped-in tensor, a view of its buffer (waits if needed)."""
        with self._lock:
            pending = name in self._pending
        if pending:
            self.synchronize()
        with self._lock:
            if name not in self._manifest:
                raise KeyError(f"no swapped tensor named {name!r}")
            if name not in self._buffers:
                raise KeyError(f"{name!r} has no host buffer; call swap_in first")
            return self._buffers[name].view(*self._manifest[name])

    # ------------------------------------------------------------- lifecycle
    def synchronize(self) -> None:
        """Wait for every queued read and write; raise if one failed."""
        try:
            self.handle.wait()
        finally:
            with self._lock:
                self._pending.clear()

    def release(self, name: str) -> None:
        self.synchronize()
        with self._lock:
            buf = self._buffers.pop(name, None)
            if buf is not None and len(self._pool) < POOL_BUFFERS:
                self._pool.append(buf)

    def stats(self) -> dict:
        return {"swap_out_bytes": self._swap_out_bytes, "swap_in_bytes": self._swap_in_bytes,
                "resident_buffers": len(self._buffers), "tracked_tensors": len(self._manifest),
                **self.handle.counts()}
