"""The flight recorder and incident bundles (``blackbox``).

Counterpart of ``deepspeed_tpu/blackbox/__init__.py``. This package is
imported only when a ds_config has a ``blackbox`` block with ``enabled``
true (or a caller arms it with :func:`configure`, as the serving
front-end's operator does). Producers across the port (the watchdog, the
chaos injector, the rewind ladder, the elastic agent, the serving
front-end and its breaker, the engine's bad-step sentinel) emit through::

    bb = sys.modules.get("deepspeed_tpu_torch.blackbox")
    if bb is not None:
        bb.record("watchdog_timeout", "error", {...}, step=step)

so a run without the block never imports it. Everything here runs on the
host: no recorder call launches on or waits for the card.

  configure(cfg, rank=0)  arm the recorder from a BlackboxConfig
  install_recorder(rec)   install a recorder built by hand
  deconfigure()           close and remove the live recorder
  get_recorder()          the live FlightRecorder, or None
  record(kind, severity, payload, step=None)  append one envelope event
  snap(reason)            write an incident bundle now
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from deepspeed_tpu_torch.telemetry.events import SCHEMA_VERSION  # noqa: F401 (re-export)

from .recorder import FlightRecorder

_recorder: Optional[FlightRecorder] = None
_recorder_source: Optional[str] = None


def configure(cfg, rank: int = 0, source: str = "config") -> Optional[FlightRecorder]:
    """Arm the recorder from a ``BlackboxConfig``; None when disabled. A new
    config-sourced recorder closes the previous config-sourced one (a new
    engine in the same process, after an elastic restart say), which
    restores the SIGUSR1 handler it had chained before the new one chains
    it again."""
    global _recorder, _recorder_source
    if cfg is None or not getattr(cfg, "enabled", False):
        return None
    if _recorder is not None and _recorder_source == "config":
        _recorder.close()
        _recorder = None
    rec = FlightRecorder(cfg, rank=rank)
    _recorder = rec
    _recorder_source = source
    return rec


def install_recorder(rec: FlightRecorder, source: str = "manual") -> None:
    """Install a recorder built by hand (tests), closing the live one."""
    global _recorder, _recorder_source
    if _recorder is not None:
        _recorder.close()
    _recorder = rec
    _recorder_source = source


def deconfigure() -> None:
    """Close and remove the live recorder, if any."""
    global _recorder, _recorder_source
    if _recorder is not None:
        _recorder.close()
    _recorder = None
    _recorder_source = None


def get_recorder() -> Optional[FlightRecorder]:
    return _recorder


def record(kind: str, severity: str, payload: Optional[Dict[str, Any]] = None,
           step: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """Append one event to the live recorder; None when none is armed."""
    rec = _recorder
    if rec is None:
        return None
    return rec.record(kind, severity, payload, step=step)


def snap(reason: str = "manual") -> Optional[str]:
    """Write an incident bundle now; its directory, or None."""
    rec = _recorder
    if rec is None:
        return None
    return rec.dump(trigger=reason, force=True)
