"""Async file I/O on torch CPU tensors: the NVMe swap's handle.

Counterpart of ``deepspeed_tpu/ops/aio.py`` (the reference's aio handle,
``csrc/aio/py_lib/deepspeed_py_aio_handle.cpp``): sync and async
``pread``/``pwrite`` of a whole tensor to or from a file, ``wait`` and
``file_size``. The library is the port's own ``csrc/aio/ds_aio.cpp``, built
with g++ into ``build/`` at first use (``op_builder.HostLibrary``) and bound
with ctypes; a build that fails raises. A tensor is passed by its
``data_ptr()`` and must be a contiguous CPU tensor, pinned or not. The I/O
goes around the page cache (``O_DIRECT``) when the tensor's address, its
byte length and the file offset are multiples of :data:`DIRECT_ALIGN`;
:func:`host_zeros` makes such tensors, pinned for the card when asked (the
offloaded state of ``runtime/zero/offload.py`` lives in them too).

    h = AsyncIOHandle(block_size=1 << 20, thread_count=8)
    h.async_pwrite(t, "/nvme/shard.bin"); ...; h.wait()
    h.sync_pread(t, "/nvme/shard.bin")

An async operation keeps its tensor referenced until :meth:`wait`. A read
that meets the end of the file before the tensor is full is an error.
"""

from __future__ import annotations

import ctypes
import mmap
import weakref
from typing import List

import torch

from deepspeed_tpu_torch.ops.op_builder import HostLibrary

DIRECT_ALIGN = 4096

_IO = (ctypes.c_long, [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t,
                       ctypes.c_size_t])
LIBRARY = HostLibrary("aio/ds_aio.cpp", {
    "aio_handle_new": (ctypes.c_void_p, [ctypes.c_int, ctypes.c_size_t, ctypes.c_int]),
    "aio_handle_free": (None, [ctypes.c_void_p]),
    "aio_pread": _IO, "aio_pwrite": _IO, "aio_sync_pread": _IO, "aio_sync_pwrite": _IO,
    "aio_wait": (ctypes.c_long, [ctypes.c_void_p]),
    "aio_file_size": (ctypes.c_long, [ctypes.c_char_p]),
    "aio_counts": (None, [ctypes.c_void_p, ctypes.POINTER(ctypes.c_long)]),
})
COUNT_KEYS = ("direct_chunks", "buffered_chunks", "direct_bytes", "buffered_bytes")


def _unregister(cudart, ptr: int, pages: mmap.mmap) -> None:
    """Unpin ``pages``, which the caller keeps mapped until this returns."""
    cudart.cudaHostUnregister(ptr)


def host_zeros(numel: int, dtype: torch.dtype = torch.uint8, pin: bool = False) -> torch.Tensor:
    """A zeroed CPU tensor of ``numel`` elements on fresh anonymous pages of
    its own: its address a multiple of the page size (so ``O_DIRECT`` takes
    it), its memory its size rounded up to a page, and, with ``pin``,
    page-locked for the card (``cudaHostRegister``) until the tensor is
    gone, the pages kept mapped until then; raises when they cannot be
    pinned. (After the free the kernel takes some seconds to count the
    unpinned pages as available again.)"""
    nbytes = numel * torch.empty((), dtype=dtype).element_size()
    if nbytes == 0:
        return torch.zeros(0, dtype=dtype)
    pages = mmap.mmap(-1, -(-nbytes // mmap.PAGESIZE) * mmap.PAGESIZE,
                      flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    t = torch.frombuffer(pages, dtype=dtype, count=numel)
    if pin:
        cudart = torch.cuda.cudart()
        err = int(cudart.cudaHostRegister(t.data_ptr(), len(pages), 0))
        if err != 0:
            raise RuntimeError(f"cannot pin {len(pages)} B of host memory for offloaded state "
                               f"(cudaHostRegister error {err})")
        weakref.finalize(t, _unregister, cudart, t.data_ptr(), pages).atexit = False
        if not t.is_pinned():
            raise RuntimeError(f"{len(pages)} B of host memory registered but not pinned")
    return t


def _buffer(t: torch.Tensor):
    if t.device.type != "cpu" or not t.is_contiguous():
        raise ValueError(f"aio buffers are contiguous CPU tensors, got {t.device} "
                         f"contiguous={t.is_contiguous()}")
    return ctypes.c_void_p(t.data_ptr()), t.numel() * t.element_size()


class AsyncIOHandle:
    """A pool of ``thread_count`` I/O threads, each request split into
    ``block_size`` chunks. ``queue_depth``, ``single_submit`` and
    ``overlap_events`` are the reference's knobs and change nothing here, as
    in the JAX package."""

    def __init__(self, block_size: int = 1 << 20, queue_depth: int = 32,
                 single_submit: bool = False, overlap_events: bool = True,
                 thread_count: int = 8, use_direct: bool = True):
        self._lib = LIBRARY.load()
        self._h = self._lib.aio_handle_new(int(thread_count), int(block_size),
                                           1 if use_direct else 0)
        self.block_size = block_size
        self.queue_depth = queue_depth
        self.thread_count = thread_count
        self._inflight: List[torch.Tensor] = []

    def close(self) -> None:
        """Wait for what is queued and free the threads."""
        if self._h:
            self._lib.aio_wait(self._h)
            self._lib.aio_handle_free(self._h)
            self._h = None
            self._inflight.clear()

    def __del__(self):
        self.close()

    # ---- async: the number of chunks queued; completion by wait() -------
    def async_pread(self, t: torch.Tensor, path: str, offset: int = 0) -> int:
        ptr, n = _buffer(t)
        r = self._lib.aio_pread(self._h, path.encode(), ptr, n, offset)
        if r < 0:
            raise IOError(f"aio: cannot open {path} for read")
        self._inflight.append(t)
        return int(r)

    def async_pwrite(self, t: torch.Tensor, path: str, offset: int = 0) -> int:
        ptr, n = _buffer(t)
        r = self._lib.aio_pwrite(self._h, path.encode(), ptr, n, offset)
        if r < 0:
            raise IOError(f"aio: cannot open {path} for write")
        self._inflight.append(t)
        return int(r)

    def wait(self) -> int:
        """Block until every queued operation is done; raise if any chunk
        failed (an I/O error or a short read)."""
        errs = int(self._lib.aio_wait(self._h))
        self._inflight.clear()
        if errs:
            raise IOError(f"aio: {errs} chunk(s) failed (an I/O error, or a read past the "
                          "end of the file)")
        return 0

    # ---- sync -------------------------------------------------------------
    def sync_pread(self, t: torch.Tensor, path: str, offset: int = 0) -> int:
        ptr, n = _buffer(t)
        r = self._lib.aio_sync_pread(self._h, path.encode(), ptr, n, offset)
        if r < 0:
            raise IOError(f"aio: sync read of {n} B from {path} failed ({r})")
        return n

    def sync_pwrite(self, t: torch.Tensor, path: str, offset: int = 0) -> int:
        ptr, n = _buffer(t)
        r = self._lib.aio_sync_pwrite(self._h, path.encode(), ptr, n, offset)
        if r < 0:
            raise IOError(f"aio: sync write of {n} B to {path} failed ({r})")
        return n

    def counts(self) -> dict:
        """The chunks and bytes completed so far that went around the page
        cache (``direct_*``) and through it (``buffered_*``: an unaligned
        tensor, a filesystem that refuses ``O_DIRECT``, or a chunk it
        refused)."""
        out = (ctypes.c_long * len(COUNT_KEYS))()
        self._lib.aio_counts(self._h, out)
        return dict(zip(COUNT_KEYS, (int(x) for x in out)))

    @staticmethod
    def file_size(path: str) -> int:
        return int(LIBRARY.load().aio_file_size(path.encode()))
