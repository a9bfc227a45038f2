"""The incident-event envelope shared by failure-path producers.

Counterpart of ``deepspeed_tpu/telemetry/events.py``: an anomaly record
(a watchdog timeout, a breaker transition, a shed or drain decision, a
chaos injection) is wrapped in one envelope shape, so records from either
package merge and order without per-kind parsers:

    {schema_version, event_id, ts, mono, step, rank, kind, severity, payload}

``ts`` is epoch seconds and ``mono`` is ``time.perf_counter()`` seconds of
the emitting process. Standard library only.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, Optional

# Bump whenever the envelope shape changes incompatibly.  Mixed-version
# fleets merge LOUDLY: ds_incident warns on every record whose
# schema_version differs from its own instead of silently mis-parsing.
SCHEMA_VERSION = 1

# Ordered least → most severe.  ``severity_rank`` tolerates unknown strings
# (treated as below "debug") so a newer producer never crashes an older
# consumer.
SEVERITIES = ("debug", "info", "warning", "error", "critical")

_SEVERITY_RANK = {name: i for i, name in enumerate(SEVERITIES)}


def severity_rank(severity: str) -> int:
    """Numeric rank of a severity name; unknown names rank below 'debug'."""
    return _SEVERITY_RANK.get(str(severity).lower(), -1)


def new_event_id() -> str:
    """Short unique id for one emitted event (stable across re-serialization)."""
    return uuid.uuid4().hex[:12]


def make_event(
    kind: str,
    severity: str,
    payload: Optional[Dict[str, Any]] = None,
    *,
    step: Optional[int] = None,
    rank: Optional[int] = None,
    ts: Optional[float] = None,
    mono: Optional[float] = None,
) -> Dict[str, Any]:
    """Build a fully-stamped envelope dict for one incident event."""
    return {
        "schema_version": SCHEMA_VERSION,
        "event_id": new_event_id(),
        "ts": round(float(ts if ts is not None else time.time()), 6),
        "mono": round(float(mono if mono is not None else time.perf_counter()), 6),
        "step": step,
        "rank": rank,
        "kind": str(kind),
        "severity": str(severity),
        "payload": dict(payload) if payload else {},
    }


def stamp_envelope(
    record: Dict[str, Any],
    *,
    kind: Optional[str] = None,
    severity: Optional[str] = None,
) -> Dict[str, Any]:
    """Stamp envelope identity onto an EXISTING record dict, in place.

    Used by writers that already have their own on-disk shape (e.g. the
    elastic agent's ``restart_log.jsonl`` records): adds ``schema_version``
    and ``event_id`` — and ``kind``/``severity`` when provided and absent —
    without disturbing existing keys, so old readers keep working while
    version-mixed merges become detectable.
    """
    record.setdefault("schema_version", SCHEMA_VERSION)
    record.setdefault("event_id", new_event_id())
    if kind is not None:
        record.setdefault("kind", str(kind))
    if severity is not None:
        record.setdefault("severity", str(severity))
    return record
