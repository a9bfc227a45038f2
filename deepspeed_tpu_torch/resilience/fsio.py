"""Atomic, retried, chaos-instrumented file writes.

Counterpart of ``deepspeed_tpu/resilience/fsio.py``: every metadata file of
a checkpoint goes payload, then the chaos hooks (``before``, then
``corrupt``, which may truncate it), then a temp file in the destination
directory, fsync, and a rename over the destination, so a crash at any
point leaves the old file or the new one, never half of one. Transient
``OSError``s (an injected :class:`ChaosError` too) are retried under the
caller's :class:`RetryPolicy`. :func:`atomic_write_stream` does the same for
a payload too large to hold twice in memory (the emergency tag's state): it
is written in pieces while its sha256 is taken, and a truncation is drawn
after the write and applied to the temp file.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
from typing import Callable, Optional, Tuple

from deepspeed_tpu_torch.resilience import chaos as _chaos
from deepspeed_tpu_torch.resilience.retry import RetryPolicy, retry


def fsync_dir(path: str) -> None:
    """Make a rename or a new entry in directory ``path`` durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_once(path: str, data: bytes, op: str) -> None:
    inj = _chaos.active_injector()
    if inj is not None:
        inj.before(op, path)
        data = inj.corrupt(op, path, data)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_bytes(path: str, data: bytes, *, op: str,
                       policy: Optional[RetryPolicy] = None) -> None:
    retry(lambda: _write_once(path, data, op), policy, op=op)


def atomic_write_text(path: str, text: str, *, op: str,
                      policy: Optional[RetryPolicy] = None) -> None:
    atomic_write_bytes(path, text.encode("utf-8"), op=op, policy=policy)


def atomic_write_json(path: str, obj, *, op: str, policy: Optional[RetryPolicy] = None,
                      **dump_kwargs) -> bytes:
    """Serialize once and write atomically; returns the bytes, so the caller
    hashes the intended content into the manifest."""
    data = json.dumps(obj, **dump_kwargs).encode("utf-8")
    atomic_write_bytes(path, data, op=op, policy=policy)
    return data


class _HashingWriter:
    """A write-only, unseekable file object that hashes and counts what it
    passes on (``zipfile`` then writes data descriptors instead of seeking
    back, so the bytes hashed are the bytes on disk). The sha256 runs on a
    thread of its own (``hashlib`` releases the GIL on large buffers), so
    it overlaps the writer's CRC and the file writes; :meth:`hexdigest`
    waits for it."""

    _QUEUED = 4                         # chunks in flight to the hashing thread

    def __init__(self, f):
        import queue

        self._f = f
        self._sha = hashlib.sha256()
        self._chunks: "queue.Queue" = queue.Queue(self._QUEUED)
        self._hasher = threading.Thread(target=self._hash, name="ds-fsio-sha256",
                                        daemon=True)
        self._hasher.start()
        self.nbytes = 0

    def _hash(self) -> None:
        while (chunk := self._chunks.get()) is not None:
            self._sha.update(chunk)

    def write(self, b) -> int:
        data = b if isinstance(b, bytes) else bytes(b)     # never a view the caller reuses
        self._chunks.put(data)
        self._f.write(data)
        self.nbytes += len(data)
        return len(data)

    def hexdigest(self) -> str:
        self.close()
        return self._sha.hexdigest()

    def close(self) -> None:
        """Stop the hashing thread (idempotent)."""
        if self._hasher.is_alive():
            self._chunks.put(None)
            self._hasher.join()

    def tell(self) -> int:
        return self.nbytes

    def read(self, *_):
        # present only because numpy's savez takes an object with ``read``
        # for a file; the writer is write-only
        raise OSError("write-only stream")

    def flush(self) -> None:
        self._f.flush()


def _stream_once(path: str, write: Callable, op: str) -> Tuple[int, str]:
    inj = _chaos.active_injector()
    if inj is not None:
        inj.before(op, path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp.")
    w = None
    try:
        with os.fdopen(fd, "wb") as f:
            w = _HashingWriter(f)
            write(w)
            f.flush()
            if inj is not None:
                kept = inj.corrupt_len(op, path, w.nbytes)
                if kept != w.nbytes:
                    f.truncate(kept)
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    finally:
        if w is not None:
            w.close()
    return w.nbytes, w.hexdigest()


def atomic_write_stream(path: str, write: Callable, *, op: str,
                        policy: Optional[RetryPolicy] = None) -> Tuple[int, str]:
    """``write(f)`` streams the payload into the file object ``f``
    (``write``, ``tell``, ``flush``; not seekable), atomically and retried as
    :func:`atomic_write_bytes`. Returns the bytes meant for the file and
    their sha256, for the manifest: a truncated write fails its check."""
    return retry(lambda: _stream_once(path, write, op), policy, op=op)
