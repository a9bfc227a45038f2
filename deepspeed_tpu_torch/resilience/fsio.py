"""Atomic, retried file writes.

Counterpart of ``deepspeed_tpu/resilience/fsio.py``: every metadata file of
a checkpoint is written as a temp file in its destination directory,
fsynced, then renamed over the destination, so a crash at any point leaves
the old file or the new one, never half of one. Transient ``OSError``s are
retried under the caller's :class:`RetryPolicy`. The JAX module also runs
each write past the chaos injector (fault drills); the injector is a later
slice of the port, so these writes have no such hook.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

from deepspeed_tpu_torch.resilience.retry import RetryPolicy, retry


def fsync_dir(path: str) -> None:
    """Make a rename or a new entry in directory ``path`` durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_once(path: str, data: bytes) -> None:
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
    retry(lambda: _write_once(path, data), policy, op=op)


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
