"""Hang detection: a wedged step or call becomes a clean timeout.

Counterpart of ``deepspeed_tpu/resilience/watchdog.py``:

* :class:`StepWatchdog`: an arm/disarm deadline around each engine step,
  ``max(min_timeout, factor x a percentile of recent step times)``
  (``startup_timeout`` before the first step time), fired by one daemon
  monitor thread. On expiry every thread's stack is dumped,
  ``resilience/watchdog_timeouts{kind=step}`` is counted, and
  :class:`WatchdogTimeout` is delivered into the armed thread with
  ``PyThreadState_SetAsyncExc`` (``on_timeout`` "raise"), or the process
  aborts with SIGABRT ("kill"). An asynchronous exception lands only
  between bytecodes: it interrupts a host-side stall (a sleep loop, a
  wedged data iterator), but NOT a thread blocked inside one C call. On
  CUDA that includes ``torch.cuda.synchronize()``, ``.item()`` or a copy
  to the host waiting on a wedged kernel: such a hang can be reported,
  never interrupted, so only ``on_timeout: "kill"`` (or the launcher's
  stale-heartbeat kill) ends it.
* :func:`run_with_deadline`: a one-shot deadline around a blocking call
  (the serving tick, the startup fingerprint broadcast): the call runs in
  a disposable worker thread, the caller gets a :class:`WatchdogTimeout`
  while a wedged worker is disowned (``kind=deadline``; unless the
  deadline is a request budget, ``stall_span=False``, a ``watchdog_stall``
  span covers the stall in the trace).
* :func:`touch_heartbeat`: the engine advances a heartbeat file's mtime
  every ``heartbeat_interval`` steps; the launcher kills the children
  when it goes stale, which works even when every thread is wedged.

The dumps (:func:`dump_all_stacks`) carry the named locks' holders.
Without the ``watchdog`` ds_config block the engine makes no
:class:`StepWatchdog`, starts no thread and writes no heartbeat.
"""

from __future__ import annotations

import math
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Callable, Optional

from deepspeed_tpu_torch.utils import locks as _locks
from deepspeed_tpu_torch.utils.logging import logger


class WatchdogTimeout(RuntimeError):
    """A watched operation blew its deadline."""


_default_dump_path: Optional[str] = None
_default_dump_path_source: Optional[str] = None


def set_default_dump_path(path: Optional[str], source: str = "manual") -> None:
    """Default file for stack dumps whose call site names none (appended
    to; stderr always gets the dump as well); None clears it. The engine
    installs ``watchdog.stack_dump_file`` here with ``source="config"``."""
    global _default_dump_path, _default_dump_path_source
    _default_dump_path = path or None
    _default_dump_path_source = None if not path else source


def clear_config_dump_path() -> None:
    """Remove a dump path an engine installed from its config (an engine
    built without the block); a manual one stays."""
    global _default_dump_path, _default_dump_path_source
    if _default_dump_path_source == "config":
        _default_dump_path = None
        _default_dump_path_source = None


def format_all_stacks() -> str:
    """Every live thread's stack, most recent call last, as text (what
    faulthandler prints, without needing a file descriptor)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append(f"Thread {names.get(ident, '?')} ({ident:#x}):\n"
                   + "".join(traceback.format_stack(frame)))
    return "\n".join(out)


def dump_all_stacks(path: Optional[str] = None, reason: str = "",
                    to_stderr: bool = True) -> None:
    """Every thread's stack and the named locks' holders, to ``path``
    (appended; default :func:`set_default_dump_path`'s) and to stderr. An
    I/O error on the file is logged, not raised: the dump is diagnostics on
    an abort already under way."""
    path = path or _default_dump_path
    text = (f"\n==== watchdog stack dump ({reason or 'requested'}) ====\n"
            + format_all_stacks() + "\n" + _locks.format_lock_holders() + "\n")
    if to_stderr:
        sys.stderr.write(text)
        sys.stderr.flush()
    if path:
        try:
            with open(path, "a") as f:
                f.write(text)
        except OSError as e:
            logger.warning(f"watchdog: stack dump to {path} failed: {e}")


def _count_timeout(kind: str, stall_s: Optional[float] = None) -> None:
    from deepspeed_tpu_torch import telemetry

    telemetry.get_registry().counter(
        "resilience/watchdog_timeouts", labels={"kind": kind}).inc()
    telemetry.get_tracer().instant("watchdog_timeout", cat="resilience", kind=kind)
    bb = sys.modules.get("deepspeed_tpu_torch.blackbox")
    if bb is not None:
        bb.record("watchdog_timeout", "error", {"kind": kind, "stall_s": stall_s})
    if stall_s is not None and stall_s > 0:
        # the stall as a complete span ending now
        telemetry.get_tracer().complete("watchdog_stall", stall_s * 1e6, cat="stall", kind=kind)


def run_with_deadline(fn: Callable, timeout: float, name: str = "op",
                      dump_path: Optional[str] = None,
                      on_timeout_info: Optional[Callable[[], str]] = None,
                      stall_span: bool = True):
    """Run ``fn()`` under a hard deadline; return its value or re-raise its
    exception. On expiry: all-thread stack dump, the ``watchdog_timeouts``
    counter and a :class:`WatchdogTimeout` in the caller; the worker
    (``ds-deadline-<name>``) is disowned. ``on_timeout_info()`` is appended
    to the message. ``stall_span=False`` leaves out the ``watchdog_stall``
    span, for a deadline that is a request's budget rather than a hang
    detector (the serving tick loop)."""
    if timeout is None or timeout <= 0:
        raise ValueError(f"run_with_deadline({name!r}): timeout must be positive, got {timeout!r}")
    result: dict = {}
    done = threading.Event()

    def worker():
        try:
            result["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised in the caller
            result["error"] = e
        finally:
            done.set()

    # expect_join=False: a worker wedged past its deadline is disowned by
    # design, and the leak sentinel does not count it
    t = _locks.spawn_thread(worker, name=f"ds-deadline-{name}", owner="watchdog",
                            daemon=True, expect_join=False)
    t.start()
    if not done.wait(timeout):
        _count_timeout("deadline", stall_s=timeout if stall_span else None)
        extra = on_timeout_info() if on_timeout_info is not None else ""
        msg = f"watchdog: {name} did not complete within {timeout:.1f}s{extra}"
        logger.error(msg)
        dump_all_stacks(dump_path, reason=msg)
        raise WatchdogTimeout(msg)
    if "error" in result:
        raise result["error"]
    return result.get("value")


def _async_raise(tid: int, message: str) -> bool:
    """Deliver :class:`WatchdogTimeout` into thread ``tid``, between its
    bytecodes (never inside a C call)."""
    import ctypes

    # the class is instantiated at delivery with no arguments, so a
    # throwaway subclass carries the message
    exc = type("WatchdogTimeout", (WatchdogTimeout,),
               {"__init__": lambda self: WatchdogTimeout.__init__(self, message)})
    n = ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(tid), ctypes.py_object(exc))
    if n > 1:       # the C API's contract broken: undo
        ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(tid), None)
        return False
    return n == 1


def _cancel_async_exc(tid: int) -> None:
    """Clear a pending, not yet delivered asynchronous exception of
    ``tid`` (a NULL exception cancels it)."""
    import ctypes

    ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(tid), None)


class StepWatchdog:
    """Arm/disarm deadline around engine steps, fired by one daemon monitor
    thread started at the first :meth:`arm` (a watchdog never armed owns
    no thread).

    Deadline: ``max(min_timeout, factor x P(percentile) of the last
    ``window`` step durations)``; with no history yet, ``startup_timeout``.
    On expiry: the stacks dumped, ``resilience/watchdog_timeouts`` counted,
    then ``on_timeout`` "raise" delivers :class:`WatchdogTimeout` into the
    armed thread, "kill" SIGABRTs the process. The exception reaches a
    thread only between bytecodes (see the module docstring: a thread
    blocked in a CUDA synchronization is reported, not interrupted)."""

    POLL_S = 0.05           # the monitor's wake-up: the detection slack

    def __init__(self, factor: float = 3.0, percentile: float = 0.95, window: int = 32,
                 min_timeout: float = 60.0, startup_timeout: float = 600.0,
                 on_timeout: str = "raise", dump_path: Optional[str] = None,
                 name: str = "step"):
        if on_timeout not in ("raise", "kill"):
            raise ValueError(f"watchdog on_timeout must be 'raise' or 'kill', got {on_timeout!r}")
        if factor <= 0 or not (0.0 < percentile <= 1.0):
            raise ValueError("watchdog factor must be > 0 and percentile in (0, 1]")
        self.factor = float(factor)
        self.percentile = float(percentile)
        self.min_timeout = float(min_timeout)
        self.startup_timeout = float(startup_timeout)
        self.on_timeout = on_timeout
        self.dump_path = dump_path
        self.name = name
        self.trips = 0
        self.last_trip_reason = ""
        self._durations: deque = deque(maxlen=int(window))
        self._lock = _locks.make_lock("watchdog.step")
        self._armed_tid: Optional[int] = None
        self._armed_at = 0.0
        self._deadline = 0.0
        # the arm generation closes the fire/disarm race: the monitor
        # records which arm it fired for, and disarm cancels a timeout of
        # the current arm not yet delivered, so it never lands in later code
        self._gen = 0
        self._fired_gen = -1
        self._cancel_gen = -1
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def observe(self, duration: float) -> None:
        """Feed a step duration without arming (tests, external timers)."""
        with self._lock:
            self._durations.append(float(duration))

    def deadline_s(self) -> float:
        """The deadline the next :meth:`arm` would use."""
        with self._lock:
            durs = sorted(self._durations)
        if not durs:
            return self.startup_timeout
        idx = min(len(durs) - 1, max(0, int(math.ceil(self.percentile * len(durs))) - 1))
        return max(self.min_timeout, self.factor * durs[idx])

    def arm(self, timeout: Optional[float] = None) -> float:
        """Start the countdown for the calling thread; returns the deadline.
        Arming again while armed moves the deadline."""
        t = float(timeout) if timeout is not None else self.deadline_s()
        with self._lock:
            self._gen += 1
            self._armed_tid = threading.get_ident()
            self._armed_at = time.monotonic()
            self._deadline = self._armed_at + t
        self._ensure_thread()
        return t

    def extend_if_armed(self, timeout: Optional[float] = None) -> bool:
        """Push the current arm's deadline ``timeout`` (default
        ``startup_timeout``) from now: a checkpoint restore inside an armed
        step (a sentinel rewind) is step-sized work. False when unarmed."""
        with self._lock:
            if self._armed_tid is None:
                return False
            t = float(timeout) if timeout is not None else self.startup_timeout
            self._deadline = time.monotonic() + t
            return True

    def disarm(self) -> Optional[float]:
        """Stop the countdown; the elapsed time joins the history. Returns
        it, or None when not armed (also when the monitor already fired for
        this arm: a timeout not yet delivered is then cancelled)."""
        with self._lock:
            if self._armed_tid is not None:
                dur = time.monotonic() - self._armed_at
                self._durations.append(dur)
                self._armed_tid = None
                return dur
            if self._fired_gen == self._gen and self._cancel_gen != self._gen:
                self._cancel_gen = self._gen
                _cancel_async_exc(threading.get_ident())
            return None

    def close(self) -> None:
        """Stop the monitor thread (engine teardown, agent restart); a
        later :meth:`arm` starts it again."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2 * self.POLL_S + 1.0)

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = _locks.spawn_thread(self._monitor, name=f"ds-watchdog-{self.name}",
                                               owner="watchdog", daemon=True)
            self._thread.start()

    def _monitor(self) -> None:
        while not self._stop.wait(self.POLL_S):
            with self._lock:
                tid = self._armed_tid
                now = time.monotonic()
                expired = tid is not None and now >= self._deadline
                waited = now - self._armed_at
                if expired:
                    self._armed_tid = None      # one shot per arm
                    gen = self._gen
                    self._fired_gen = gen       # disarm may now cancel it
            if expired:
                self._fire(tid, gen, waited)

    # separate, so tests can replace the process kill
    _kill = staticmethod(lambda: os.kill(os.getpid(), signal.SIGABRT))

    def _fire(self, tid: int, gen: int, waited: float) -> None:
        msg = (f"watchdog[{self.name}]: armed operation exceeded its {waited:.1f}s deadline "
               f"(policy: max({self.min_timeout:g}s, {self.factor:g} x "
               f"p{int(self.percentile * 100)} of recent steps))")
        self.trips += 1
        self.last_trip_reason = msg
        _count_timeout(self.name, stall_s=waited)
        logger.error(msg)
        dump_all_stacks(self.dump_path, reason=msg)
        if self.on_timeout == "kill":
            logger.error(f"watchdog[{self.name}]: on_timeout=kill — aborting the process")
            self._kill()
            return
        with self._lock:
            # the dump is slow: the step may have finished and disarmed
            if self._cancel_gen == gen:
                logger.warning(f"watchdog[{self.name}]: operation completed just past its "
                               "deadline; timeout not delivered")
                return
            delivered = _async_raise(tid, msg)
        if not delivered:
            logger.warning(f"watchdog[{self.name}]: armed thread {tid} vanished before the "
                           "timeout could be delivered")


def touch_heartbeat(path: str) -> bool:
    """Advance the heartbeat file's mtime, creating it first. An I/O error
    is logged, never raised: the stale heartbeat it causes is the signal."""
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a"):
            pass
        os.utime(path, None)
        return True
    except OSError as e:
        logger.warning(f"watchdog: heartbeat touch failed for {path}: {e}")
        return False
