"""Hard deadlines around blocking calls: a hang becomes a clean timeout.

Counterpart of the part of ``deepspeed_tpu/resilience/watchdog.py`` the
serving front-end uses: :func:`run_with_deadline` runs a call in a
disposable worker thread; the caller waits with a timeout and gets a
:class:`WatchdogTimeout` back while a wedged worker is disowned (a daemon
thread cannot be cancelled, only left behind). On expiry the stacks of
every thread are dumped (:func:`dump_all_stacks`, with the named locks'
holders), ``resilience/watchdog_timeouts{kind=deadline}`` is counted and,
unless the deadline is a request budget (``stall_span=False``), a
``watchdog_stall`` span covers the stall in the trace.

The per-step ``StepWatchdog``, the heartbeat file and the ``watchdog``
ds_config block are a later slice of the port.
"""

from __future__ import annotations

import sys
import threading
import traceback
from typing import Callable, Optional

from deepspeed_tpu_torch.utils import locks as _locks
from deepspeed_tpu_torch.utils.logging import logger


class WatchdogTimeout(RuntimeError):
    """A watched operation blew its deadline."""


_default_dump_path: Optional[str] = None


def set_default_dump_path(path: Optional[str]) -> None:
    """Default file for stack dumps whose call site names none (appended
    to; stderr always gets the dump as well); None clears it."""
    global _default_dump_path
    _default_dump_path = path or None


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
