"""The flight recorder: a bounded in-memory ring of incident events.

Counterpart of ``deepspeed_tpu/blackbox/recorder.py``. Producers call
:meth:`FlightRecorder.record` only when something noteworthy happens (a
timeout, a transition, a recovery); the per-step hook :meth:`on_step` is
one deque append under the ring lock. The ring is copied and released
before any bundle I/O: no file is written while the ring lock is held.

Every timestamp is the host's. :meth:`on_step` reads no tensor and never
waits for the card: a CUDA launch returns before the card runs it, so a
step's host boundary is what the tail records (``wall_s`` stays None, as
in JAX).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from deepspeed_tpu_torch import telemetry as _telemetry
from deepspeed_tpu_torch.telemetry.events import make_event, severity_rank
from deepspeed_tpu_torch.utils import locks as _locks
from deepspeed_tpu_torch.utils.logging import logger

# a forced bundle (SIGUSR1, snap) within this many seconds of the last one
# is the same request seen twice: one SIGUSR1 reaches both the elastic
# agent's chained handler and the recorder's
SNAP_DEBOUNCE_S = 2.0


class FlightRecorder:
    """Bounded ring of envelope events, rolling step tail, bundle trigger.

    One recorder per process. An event of severity ``trigger_severity`` or
    worse writes an incident bundle, at most one per
    ``min_trigger_interval_s``.
    """

    def __init__(self, cfg, rank: int = 0):
        self.cfg = cfg
        self.rank = int(rank)
        # clock anchor, epoch and monotonic taken back to back: event
        # timestamps derive from the monotonic clock (they order right even
        # if NTP steps the wall clock), and the anchor lets the incident
        # report place ranks on one axis
        self._t0 = time.perf_counter()
        self.epoch0 = time.time()
        # reentrant: a producer may emit from a signal handler that
        # interrupted this thread's own append
        self._lock = _locks.make_rlock("blackbox.ring")
        self._ring: deque = deque(maxlen=max(1, int(cfg.ring_size)))
        self._step_tail: deque = deque(maxlen=max(1, int(cfg.metric_tail)))
        self.last_step: Optional[int] = None
        self.events_total = 0
        self.errors_total = 0
        self.bundles_written = 0
        self.last_trigger: Optional[str] = None
        self.last_bundle_dir: Optional[str] = None
        self._overhead_us = 0.0
        self._steps_seen = 0
        # stamped by the engine when it arms the recorder: the bundle
        # manifest's identity, which the incident report compares across ranks
        self.config_fingerprint: Optional[str] = None
        self.world_size: Optional[int] = None
        self._last_bundle_mono: Optional[float] = None
        self._trigger_rank = severity_rank(getattr(cfg, "trigger_severity", "error"))
        self._closed = False
        self._signal_event = threading.Event()
        self._signal_thread = None
        self._prev_sigusr1 = None
        if getattr(cfg, "signal_snap", True):
            self._arm_signal()

    # ---------------------------------------------------------------- clock
    def now(self) -> Dict[str, float]:
        """A paired (epoch, monotonic) stamp derived from the anchor."""
        mono = time.perf_counter()
        return {"ts": self.epoch0 + (mono - self._t0), "mono": mono}

    def clock_anchor(self) -> Dict[str, float]:
        return {"epoch_s": self.epoch0, "monotonic_s": self._t0}

    # ------------------------------------------------------------ recording
    def record(self, kind: str, severity: str, payload: Optional[Dict[str, Any]] = None,
               step: Optional[int] = None) -> Dict[str, Any]:
        """Append one envelope event; it may trigger a bundle (written off
        the lock)."""
        t_in = time.perf_counter()
        stamp = self.now()
        ev = make_event(kind, severity, payload,
                        step=step if step is not None else self.last_step,
                        rank=self.rank, ts=stamp["ts"], mono=stamp["mono"])
        sev_rank = severity_rank(severity)
        with self._lock:
            self._ring.append(ev)
            self.events_total += 1
            if sev_rank >= severity_rank("error"):
                self.errors_total += 1
            should_dump = (sev_rank >= self._trigger_rank and not self._closed
                           and self._bundle_allowed_locked())
            if should_dump:
                # claim the rate-limit slot under the lock, so concurrent
                # error events race for one bundle at most
                self._last_bundle_mono = time.perf_counter()
        self._count_metrics(kind, severity)
        self._overhead_us += (time.perf_counter() - t_in) * 1e6
        if should_dump:
            # outside the lock and outside the overhead window: the
            # overhead is the always-on append, not the rare dump
            self.dump(trigger=kind, _preclaimed=True)
        return ev

    def on_step(self, step: int, wall_s: Optional[float] = None) -> None:
        """The per-step tail sample: one locked deque append."""
        t_in = time.perf_counter()
        stamp_ts = self.epoch0 + (t_in - self._t0)
        with self._lock:
            self.last_step = int(step)
            self._steps_seen += 1
            self._step_tail.append({"step": int(step), "ts": round(stamp_ts, 6),
                                    "wall_s": round(wall_s, 6) if wall_s is not None else None})
        self._overhead_us += (time.perf_counter() - t_in) * 1e6

    def _count_metrics(self, kind: str, severity: str) -> None:
        try:
            reg = _telemetry.get_registry()
            reg.counter("blackbox/events", labels={"severity": severity}).inc()
            reg.gauge("blackbox/ring_fill").set(len(self._ring))
        except Exception:  # noqa: BLE001 - metrics never break recording
            pass

    # ------------------------------------------------------------ snapshots
    def ring_snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def step_tail_snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._step_tail)

    def overhead_us(self) -> float:
        return self._overhead_us

    def steps_seen(self) -> int:
        return self._steps_seen

    # -------------------------------------------------------------- bundles
    def _bundle_allowed_locked(self) -> bool:
        if self._last_bundle_mono is None:
            return True
        gap = time.perf_counter() - self._last_bundle_mono
        return gap >= float(getattr(self.cfg, "min_trigger_interval_s", 30.0))

    def output_dir(self) -> Optional[str]:
        """``output_dir`` of the block, else the telemetry session's."""
        base = getattr(self.cfg, "output_dir", None)
        if base:
            return base
        sess = _telemetry.get_session()
        if sess is not None and getattr(sess, "output_dir", None):
            return sess.output_dir
        return None

    def dump(self, trigger: str, force: bool = False,
             _preclaimed: bool = False) -> Optional[str]:
        """Write an incident bundle; its directory, or None. ``force``
        bypasses the rate limit (SIGUSR1, ``snap``), not the debounce."""
        if not _preclaimed:
            with self._lock:
                if not force and not self._bundle_allowed_locked():
                    logger.warning(f"blackbox: bundle for trigger {trigger!r} suppressed by "
                                   "min_trigger_interval_s="
                                   f"{getattr(self.cfg, 'min_trigger_interval_s', 30.0):.1f}")
                    return None
                if force and self._last_bundle_mono is not None and \
                        time.perf_counter() - self._last_bundle_mono < SNAP_DEBOUNCE_S:
                    return None
                self._last_bundle_mono = time.perf_counter()
        base = self.output_dir()
        if base is None:
            logger.warning(f"blackbox: trigger {trigger!r} but no output dir (set "
                           "blackbox.output_dir or telemetry.output_dir); bundle dropped")
            return None
        from deepspeed_tpu_torch.blackbox import bundle as _bundle

        try:
            path = _bundle.write_bundle(self, trigger, base)
        except Exception as e:  # noqa: BLE001 - forensics never stop training
            logger.warning(f"blackbox: bundle write for trigger {trigger!r} failed: {e}")
            return None
        self.bundles_written += 1
        self.last_trigger = trigger
        self.last_bundle_dir = path
        try:
            _telemetry.get_registry().counter("blackbox/bundles",
                                              labels={"trigger": trigger}).inc()
        except Exception:  # noqa: BLE001
            pass
        logger.warning(f"blackbox: incident bundle written: {path} (trigger={trigger})")
        _bundle.prune_bundles(os.path.join(base, "incidents"),
                              int(getattr(self.cfg, "max_bundles", 8)))
        return path

    # -------------------------------------------------------------- signals
    def _arm_signal(self) -> None:
        """SIGUSR1 → a bundle, through the ``ds-blackbox-signal`` thread.
        The handler only sets an Event and calls the handler registered
        before it; the stack dump and the bundle run on the thread."""
        if threading.current_thread() is not threading.main_thread():
            return
        if not hasattr(signal, "SIGUSR1"):
            return

        @_locks.signal_safe("sets an Event; I/O deferred to the ds-blackbox-signal thread")
        def _handler(signum, frame):
            self._signal_event.set()
            # the handler registered before this one (the elastic agent's
            # stack dump): chained, not dropped
            prev = self._prev_sigusr1
            if callable(prev):
                prev(signum, frame)

        try:
            self._prev_sigusr1 = signal.signal(signal.SIGUSR1, _handler)
        except (ValueError, OSError):
            return
        self._signal_thread = _locks.spawn_thread(
            self._signal_loop, name="ds-blackbox-signal", owner="blackbox",
            daemon=True, expect_join=True)
        self._signal_thread.start()

    def _signal_loop(self) -> None:
        while not self._closed:
            if not self._signal_event.wait(timeout=0.25):
                continue
            self._signal_event.clear()
            if self._closed:
                break
            try:
                from deepspeed_tpu_torch.resilience import watchdog as _wd

                _wd.dump_all_stacks(None, reason="SIGUSR1 (blackbox snap)")
            except Exception:  # noqa: BLE001
                pass
            self.dump(trigger="sigusr1", force=True)

    # ---------------------------------------------------------------- close
    def close(self) -> None:
        """Stop the signal thread (joined) and restore the SIGUSR1 handler
        this recorder replaced."""
        self._closed = True
        if self._signal_thread is not None:
            self._signal_event.set()
            self._signal_thread.join(timeout=2.0)
            self._signal_thread = None
        if self._prev_sigusr1 is not None:
            try:
                if threading.current_thread() is threading.main_thread():
                    signal.signal(signal.SIGUSR1, self._prev_sigusr1)
            except (ValueError, OSError):
                pass
            self._prev_sigusr1 = None
