"""Named locks and the framework thread registry.

Counterpart of ``deepspeed_tpu/utils/locks.py``. Every lock of the port's
serving front-end and telemetry is built through :func:`make_lock` /
:func:`make_rlock` / :func:`make_condition` with a stable dotted NAME
(``"serving.frontend"``, ``"telemetry.counter"``, ...). The name is the
lock's *order class*: a lock shared across objects (the front-end and its
breaker share one RLock) is one node, and per-instance locks (one per
telemetry counter) collapse into one class.

Three cheap services ride the wrappers, as in the JAX package:

* **lock witness** (opt-in, :func:`enable_witness`): every acquisition
  made while other named locks are held records a ``held -> acquired``
  edge (per thread, first sites kept) into a process-global order graph;
  :func:`save_witness` writes it as JSON for an offline inversion check.
* **holder table**: each wrapper tracks its holder thread and acquisition
  site, so :func:`format_lock_holders` names who holds what in the
  watchdog's stack dump (``resilience/watchdog.py``).
* **thread registry + leak sentinel**: framework threads are spawned
  through :func:`spawn_thread` (name, owner, daemon flag, join
  expectation); :func:`leaked_threads` returns those still alive that
  their owner's teardown should have joined.

Standard library only: the telemetry registry's own locks come from this
factory, so this module never imports telemetry.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "make_lock", "make_rlock", "make_condition", "WitnessLock",
    "enable_witness", "disable_witness", "reset_witness", "witness_enabled",
    "witness_edges", "save_witness",
    "current_lock_holders", "format_lock_holders",
    "spawn_thread", "register_thread", "framework_threads",
    "live_framework_threads", "leaked_threads", "signal_safe",
]

# Guards the witness tables and registries themselves. A raw lock by
# design: instrumenting the instrument would witness its own bookkeeping
# and recurse; it is a leaf lock (never held across any other acquire).
_state_lock = threading.Lock()
_witness_on = False
# (held_name, acquired_name) -> {count, src_site, dst_site}; first sites win
_edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
_tls = threading.local()
_all_locks: List[Any] = []      # weakrefs to every WitnessLock ever made
_threads: List["ThreadRecord"] = []

_THIS_FILE = __file__


def _caller_site() -> str:
    """file:line of the nearest frame outside this module — the
    acquisition site cited by the witness and the holder table."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == _THIS_FILE:
        f = f.f_back
    if f is None:       # pragma: no cover - interpreter teardown
        return "<unknown>"
    return f"{f.f_code.co_filename}:{f.f_lineno}"


def _held_stack() -> list:
    s = getattr(_tls, "held", None)
    if s is None:
        s = _tls.held = []
    return s


def _record_acquire(name: str, site: str) -> None:
    held = _held_stack()
    if _witness_on and held:
        with _state_lock:
            for h_name, h_site in held:
                if h_name == name:
                    continue        # reentrant same-class nesting
                e = _edges.get((h_name, name))
                if e is None:
                    _edges[(h_name, name)] = {
                        "count": 1, "src_site": h_site, "dst_site": site}
                else:
                    e["count"] += 1
    held.append((name, site))


def _pop_held(name: str) -> None:
    held = _held_stack()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] == name:
            del held[i]
            return


class WitnessLock:
    """A named Lock/RLock wrapper: witness edges + holder bookkeeping.
    Satisfies the full ``threading.Condition`` lock protocol
    (``_is_owned`` / ``_release_save`` / ``_acquire_restore``), so
    ``threading.Condition(make_rlock(...))`` works unchanged."""

    def __init__(self, name: str, inner, reentrant: bool):
        self.name = name
        self._inner = inner
        self._reentrant = reentrant
        self._holder: Optional[threading.Thread] = None
        self._holder_site: Optional[str] = None
        self._since = 0.0
        self._depth = 0     # mutated only by the owning thread

    # ------------------------------------------------------------ protocol
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        site = _caller_site()
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._acquired(site)
        return got

    def _acquired(self, site: str) -> None:
        if (self._reentrant and self._depth > 0
                and self._holder is threading.current_thread()):
            self._depth += 1
            return
        self._depth = 1
        self._holder = threading.current_thread()
        self._holder_site = site
        self._since = time.monotonic()
        _record_acquire(self.name, site)

    def release(self) -> None:
        self._released()
        self._inner.release()

    def _released(self) -> None:
        if self._reentrant and self._depth > 1:
            self._depth -= 1
            return
        self._depth = 0
        self._holder = None
        self._holder_site = None
        _pop_held(self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        fn = getattr(self._inner, "locked", None)
        return fn() if fn is not None else self._holder is not None

    # Condition protocol: delegate to the inner lock where it exists
    # (RLock), approximate via the holder for a plain Lock.
    def _is_owned(self) -> bool:
        fn = getattr(self._inner, "_is_owned", None)
        if fn is not None:
            return fn()
        return self._holder is threading.current_thread()

    def _release_save(self):
        saved = (self._depth, self._holder_site)
        self._depth = 0
        self._holder = None
        self._holder_site = None
        _pop_held(self.name)
        fn = getattr(self._inner, "_release_save", None)
        if fn is not None:
            return (fn(), saved)
        self._inner.release()
        return (None, saved)

    def _acquire_restore(self, state) -> None:
        inner_state, (depth, site) = state
        fn = getattr(self._inner, "_acquire_restore", None)
        if fn is not None:
            fn(inner_state)
        else:
            self._inner.acquire()
        self._depth = depth
        self._holder = threading.current_thread()
        self._holder_site = site
        self._since = time.monotonic()
        # re-taking after a Condition.wait is not a new ordering decision:
        # push the held entry back without recording edges
        _held_stack().append((self.name, site))

    def __repr__(self):
        h = self._holder
        return (f"<WitnessLock {self.name!r} "
                f"{'held by ' + h.name if h else 'unheld'}>")


def _register_lock(lk: WitnessLock) -> None:
    import weakref

    with _state_lock:
        _all_locks.append(weakref.ref(lk))
        if len(_all_locks) > 4096:      # prune dead refs, bound memory
            _all_locks[:] = [r for r in _all_locks if r() is not None]


def make_lock(name: str) -> WitnessLock:
    """A named non-reentrant lock (``threading.Lock`` semantics)."""
    lk = WitnessLock(name, threading.Lock(), reentrant=False)
    _register_lock(lk)
    return lk


def make_rlock(name: str) -> WitnessLock:
    """A named reentrant lock (``threading.RLock`` semantics)."""
    lk = WitnessLock(name, threading.RLock(), reentrant=True)
    _register_lock(lk)
    return lk


def make_condition(name: str,
                   lock: Optional[WitnessLock] = None) -> threading.Condition:
    """A condition variable over a named witness RLock — a fresh one, or
    an existing witness rlock passed in (the serving frontend shares its
    rlock with the breaker so queue + breaker state are one order class)."""
    return threading.Condition(lock if lock is not None else make_rlock(name))


# -------------------------------------------------------------- witness API
def enable_witness(reset: bool = False) -> None:
    global _witness_on
    if reset:
        reset_witness()
    _witness_on = True


def disable_witness() -> None:
    global _witness_on
    _witness_on = False


def witness_enabled() -> bool:
    return _witness_on


def reset_witness() -> None:
    with _state_lock:
        _edges.clear()


def witness_edges() -> List[Dict[str, Any]]:
    """The observed order graph: one entry per (held, acquired) name pair
    with first-occurrence citations for both sides."""
    with _state_lock:
        return [{"src": s, "dst": d, "count": e["count"],
                 "src_site": e["src_site"], "dst_site": e["dst_site"]}
                for (s, d), e in _edges.items()]


def save_witness(path: str) -> None:
    """Persist the order graph as JSON for the offline witness pass
    (an offline inversion check reads it)."""
    import json

    with open(path, "w") as f:
        json.dump({"version": 1, "edges": witness_edges()}, f, indent=2)


# ---------------------------------------------------------- holder table
def current_lock_holders() -> List[Dict[str, Any]]:
    """Every instrumented lock currently held: name, holder thread,
    acquisition site, held-for seconds."""
    rows = []
    now = time.monotonic()
    with _state_lock:
        refs = list(_all_locks)
    for ref in refs:
        lk = ref()
        if lk is None:
            continue
        holder, site, since = lk._holder, lk._holder_site, lk._since
        if holder is not None:
            rows.append({"lock": lk.name, "holder": holder.name,
                         "site": site or "<unknown>",
                         "held_s": max(0.0, now - since)})
    return rows


def format_lock_holders() -> str:
    """The current-lock-holders table appended to the watchdog's stack
    dump — a live wedge names its holder."""
    rows = current_lock_holders()
    if not rows:
        return "lock holders: none (no instrumented lock is held)"
    lines = ["lock holders:"]
    for r in sorted(rows, key=lambda r: -r["held_s"]):
        lines.append(f"  {r['lock']:<28} held {r['held_s']:7.2f}s by "
                     f"{r['holder']:<24} acquired at {r['site']}")
    return "\n".join(lines)


# ------------------------------------------------------- thread registry
class ThreadRecord:
    __slots__ = ("thread", "name", "owner", "daemon", "expect_join")

    def __init__(self, thread: threading.Thread, owner: str,
                 expect_join: bool):
        self.thread = thread
        self.name = thread.name
        self.owner = owner
        self.daemon = thread.daemon
        self.expect_join = expect_join

    def __repr__(self):
        return (f"<ThreadRecord {self.name!r} owner={self.owner} "
                f"daemon={self.daemon} expect_join={self.expect_join} "
                f"{'alive' if self.thread.is_alive() else 'dead'}>")


def register_thread(t: threading.Thread, *, owner: str,
                    expect_join: bool = True) -> threading.Thread:
    """Adopt an already-built thread into the lifecycle registry."""
    with _state_lock:
        _threads.append(ThreadRecord(t, owner, expect_join))
        if len(_threads) > 1024:    # prune the dead, bound memory
            _threads[:] = [r for r in _threads if r.thread.is_alive()]
    return t

def spawn_thread(target, *, name: str, owner: str, daemon: bool = True,
                 expect_join: bool = True, args: tuple = (),
                 kwargs: Optional[dict] = None) -> threading.Thread:
    """Build + register (NOT start) a framework thread. ``name`` must be
    stable and owner-prefixed (``ds-<owner>-...``) so SIGUSR1 faulthandler
    dumps read; ``expect_join=False`` marks threads that are abandoned by
    design (watchdog deadline workers wedged past their deadline)."""
    t = threading.Thread(target=target, name=name, daemon=daemon,
                         args=args, kwargs=kwargs or {})
    return register_thread(t, owner=owner, expect_join=expect_join)


def framework_threads() -> List[ThreadRecord]:
    with _state_lock:
        return list(_threads)


def live_framework_threads(owner: Optional[str] = None) -> List[ThreadRecord]:
    return [r for r in framework_threads()
            if r.thread.is_alive() and (owner is None or r.owner == owner)]


def leaked_threads(timeout: float = 5.0,
                   owner: Optional[str] = None) -> List[ThreadRecord]:
    """The leak sentinel: framework threads still alive that were EXPECTED
    to be joined by their owner's teardown. Grants each up to ``timeout``
    seconds total to finish (teardown is asynchronous), then returns the
    survivors — the caller asserts the list is empty."""
    deadline = time.monotonic() + timeout
    leaked = [r for r in live_framework_threads(owner) if r.expect_join]
    for r in leaked:
        r.thread.join(max(0.0, deadline - time.monotonic()))
    return [r for r in leaked if r.thread.is_alive()]


# ------------------------------------------------------------ signal safety
def signal_safe(justification: str):
    """Mark a function as safe to call from a Python signal handler, with
    the reason written down (``fn.__signal_safe__``; an empty reason is
    refused). Changes nothing at run time."""
    if not str(justification).strip():
        raise ValueError("signal_safe needs a justification")

    def deco(fn):
        fn.__signal_safe__ = justification
        return fn

    return deco
