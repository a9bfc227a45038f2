"""Cross-rank consistency guard: make a silent desync loud.

Counterpart of ``deepspeed_tpu/resilience/consistency.py``. Two ranks that
keep running but have diverged (another checkpoint, config or code) run
collectives that still complete while training corrupts. The guard checks
at two points:

* **init**: every rank hashes (config, world, code versions) into a
  fingerprint; rank 0's is broadcast (``comm.broadcast_object_list``,
  under ``run_with_deadline`` with the barrier timeout) and a rank that
  differs raises :class:`DesyncError` naming itself before the first step;
* **every N steps** (``watchdog.consistency_interval``): the ranks
  allgather (``comm.allgather_host``) a digest of (step counter, loss
  **bits**, RNG hash); the rows must be byte-identical, and a mismatch
  raises :class:`DesyncError` naming the divergent rank(s) (majority vote,
  ties toward rank 0's value). A mixed protocol version is reported as
  such before any vote.

The loss enters as its float32 bit pattern, so drift below any printed
precision trips the guard. A world of one computes the digests and runs
no collective. The fingerprint is the port's own (its code versions are
``deepspeed_tpu_torch`` and torch), not equal to the JAX package's hash.
"""

from __future__ import annotations

import hashlib
import json
from typing import List, Optional

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger


# The version byte of every step-agreement row (JAX's): bumped when the
# digest's recipe changes, so a mixed-version world is named as such
# instead of as a divergent rank.
PROTO_VERSION = 2


class DesyncError(RuntimeError):
    """Two ranks disagree on state that SPMD requires to be identical
    (config/topology/code at init; step counter, loss bits, or RNG key
    during training). Not restartable in-process: the job must restart
    whole (the launcher / scheduler's role) after the divergence cause is
    fixed."""


def _code_versions() -> dict:
    import torch

    import deepspeed_tpu_torch

    return {"deepspeed_tpu_torch": getattr(deepspeed_tpu_torch, "__version__", "0"),
            "torch": torch.__version__}


def config_fingerprint(param_dict: dict, mesh=None, extra=None) -> str:
    """sha256 over the canonical JSON of (ds_config, world, code
    versions[, extra]): what every rank of one job must agree on. ``mesh``
    is the world's description (the engine passes its world signature)."""
    payload = {
        "config": param_dict,
        "mesh": mesh,
        "code": _code_versions(),
        "extra": extra,
    }
    blob = json.dumps(payload, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


def step_digest(step: int, loss: float, rng_bytes: bytes = b"",
                extra: bytes = b"") -> str:
    """Digest of the per-step agreement tuple. ``loss`` is hashed as its
    float32 BIT PATTERN (non-finite safe, sub-repr drift visible).
    ``extra`` carries further agreement bytes of the caller's (JAX's
    silent-data-corruption checksum rides there)."""
    h = hashlib.sha256()
    h.update(np.int64(step).tobytes())
    h.update(np.float32(loss).tobytes())
    h.update(rng_bytes)
    h.update(extra)
    return h.hexdigest()


def find_divergent(rows) -> List[int]:
    """Indices whose row differs from the majority value (ties resolve
    toward the first — i.e. rank 0's — value)."""
    from collections import Counter

    keys = [bytes(bytearray(np.asarray(r, dtype=np.uint8))) for r in rows]
    majority, _ = Counter(keys).most_common(1)[0]
    return [i for i, k in enumerate(keys) if k != majority]


def _gather_rows(digest_hex: str) -> np.ndarray:
    """Allgather this process's digest; returns (nproc, 33) uint8 rows —
    byte 0 is :data:`PROTO_VERSION`, bytes 1..32 the sha256 digest.
    (Separate, so tests can fabricate rosters.) Through
    ``comm.allgather_host``."""
    from deepspeed_tpu_torch.comm import comm as _comm

    buf = np.frombuffer(bytes([PROTO_VERSION]) + bytes.fromhex(digest_hex),
                        dtype=np.uint8)
    rows = np.asarray(_comm.allgather_host(buf))
    return rows.reshape(-1, buf.size)


def check_row_agreement(rows: np.ndarray, step: int) -> List[int]:
    """The row-checking half of :func:`check_step_agreement`, factored so
    tests can fabricate mixed-version rosters without multiple hosts.
    Rows are (nproc, 33) uint8: version byte + digest. A version-column
    disagreement raises ``desync(kind=proto)`` — software skew, not a
    divergent rank — BEFORE any digest vote; otherwise returns the
    divergent-rank indices of the digest columns."""
    rows = np.asarray(rows, dtype=np.uint8)
    versions = sorted({int(v) for v in rows[:, 0]})
    if len(versions) > 1:
        _count_desync("proto")
        raise DesyncError(
            f"cross-rank desync at step {step} (kind=proto): ranks are "
            f"speaking agreement-protocol versions {versions} — this fleet "
            "is running MIXED code versions, so digest differences would "
            "be meaningless; align every host on one deepspeed_tpu_torch "
            "version before diagnosing state divergence")
    return find_divergent(rows[:, 1:])


def _count_desync(kind: str) -> None:
    from deepspeed_tpu_torch import telemetry

    telemetry.get_registry().counter(
        "resilience/desync_detected", labels={"kind": kind}).inc()
    telemetry.get_tracer().instant("desync_detected", cat="resilience", kind=kind)


def verify_startup_consistency(param_dict: dict, mesh=None, extra=None,
                               timeout: Optional[float] = None) -> str:
    """All-rank agreement on the config/topology/code fingerprint, run once
    at engine init. Returns the fingerprint; raises :class:`DesyncError`
    on the mismatching rank(s) before any training collective runs.

    ``timeout`` bounds the broadcast (the engine passes its
    ``watchdog.barrier_timeout``): it runs before the step watchdog is
    armed, so a peer that died between the rendezvous and the engine's
    init must end in a ``WatchdogTimeout`` here. (The periodic agreement
    runs inside the armed step.)"""
    from deepspeed_tpu_torch.comm import comm as _comm

    fp = config_fingerprint(param_dict, mesh=mesh, extra=extra)
    if _comm.get_world_size() == 1:
        return fp
    bcast = lambda: _comm.broadcast_object_list([fp], src=0)
    if timeout is not None:
        from deepspeed_tpu_torch.resilience.watchdog import run_with_deadline

        ref = run_with_deadline(bcast, timeout=timeout,
                                name="startup_fingerprint_broadcast")[0]
    else:
        ref = bcast()[0]
    if ref != fp:
        _count_desync("startup_fingerprint")
        raise DesyncError(
            f"rank {_comm.get_rank()}: config/topology/code fingerprint "
            f"{fp[:12]}… does not match rank 0's {ref[:12]}… — this process "
            "is running a different config, mesh, or code version than the "
            "rest of the job; refusing to train into silent corruption")
    return fp


def check_step_agreement(step: int, loss: float, rng=None,
                         extra: bytes = b"") -> str:
    """Every-N-steps agreement round on (step counter, loss bits, RNG-key
    hash[, extra agreement bytes]).
    Returns the digest; raises :class:`DesyncError` naming the
    divergent rank(s) on mismatch, or ``desync(kind=proto)`` when the
    fleet disagrees on the agreement protocol itself (mixed code
    versions). A world of one: the digest only, no collective."""
    from deepspeed_tpu_torch.comm import comm as _comm

    rng_bytes = b"" if rng is None else np.asarray(rng).tobytes()
    digest = step_digest(step, loss, rng_bytes, extra=extra)
    if _comm.get_world_size() == 1:
        return digest
    rows = _gather_rows(digest)
    bad = check_row_agreement(rows, step)
    if bad:
        _count_desync("step_agreement")
        me = _comm.get_rank()
        role = "this rank is divergent" if me in bad else "this rank agrees with the majority"
        logger.error(f"consistency guard: desync at step {step}: rank(s) {bad} "
                     f"disagree on (step, loss bits, rng hash); {role}")
        raise DesyncError(
            f"cross-rank desync at step {step}: rank(s) {bad} disagree on "
            "(step counter, loss bits, RNG-key hash) — training state has "
            "silently diverged; aborting before it corrupts further")
    return digest
