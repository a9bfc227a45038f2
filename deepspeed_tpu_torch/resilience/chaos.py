"""Seedable fault injection for the serving tick: the step-oriented faults.

Counterpart of ``deepspeed_tpu/resilience/chaos.py``, the part this slice
hooks: the serving front-end calls ``injector.before("decode_step",
request_id)`` at each tick (the prefill and every decode chunk), inside the
tick's deadline, when :meth:`ChaosInjector.targets` says a fault aims
there. Three fault classes, scripted per call count (1-based, per op) or
drawn per call from one ``random.Random(seed)`` stream in the JAX order, so
a seed and a script give the JAX injector's sequence:

* ``fail`` (``fail_at`` / ``failure_rate``): raise :class:`ChaosError`;
* ``hang`` (``hang_at`` / ``hang_rate``): stall ``hang_s`` seconds in an
  interruptible sleep loop, which the tick's deadline turns into a clean
  timeout;
* ``delay`` (``delay_at`` sleeps ``max_delay_s``; ``delay_rate`` a uniform
  draw up to it): latency, not a hang.

Every other fault class of the JAX injector (truncate/``corrupt``, kill,
preempt, shrink/grow, bitflip, slow_device, collective_mismatch) and every
other hook (the checkpoint I/O ops, ``train_step``, ``collective``) belongs
to a later slice: naming one raises ``NotImplementedError`` in the
constructor, and a rate needs ``ops=["decode_step"]``, since without
``ops`` the JAX injector's rates reach those hooks too. The
``resilience.chaos`` ds_config block keeps raising for the same reason.

Activation: :func:`install_chaos` (tests, drills) or the ``DS_CHAOS``
environment variable, e.g. ``DS_CHAOS="seed=7,hang_rate=0.1,hang_s=2,
ops=decode_step"`` (``ops`` is ``+``-separated).
"""

from __future__ import annotations

import os
import random
import time
from collections import defaultdict
from typing import Dict, Iterable, Optional, Sequence

from deepspeed_tpu_torch.utils.logging import logger

HOOKED_OPS = frozenset({"decode_step"})
LATER = "a later slice of the port (the front-end's decode_step is the only hook yet)"


class ChaosError(OSError):
    """An injected fault (an OSError, as the flaky I/O it stands in for)."""


class ChaosInjector:
    """Deterministic fault plan for the ``decode_step`` hook: scripted
    (``fail_at={"decode_step": [1, 2]}`` fails the 1st and 2nd tick) and/or
    randomized (``failure_rate`` / ``hang_rate`` / ``delay_rate`` draw per
    call from ``random.Random(seed)``). ``ops`` restricts injection to the
    ops it names (None: every op the script names)."""

    def __init__(self, seed: int = 0, failure_rate: float = 0.0,
                 truncate_rate: float = 0.0, delay_rate: float = 0.0,
                 max_delay_s: float = 0.02,
                 hang_rate: float = 0.0, hang_s: float = 3600.0,
                 ops: Optional[Iterable[str]] = None,
                 fail_at: Optional[Dict[str, Sequence[int]]] = None,
                 truncate_at: Optional[Dict[str, Sequence[int]]] = None,
                 hang_at: Optional[Dict[str, Sequence[int]]] = None,
                 delay_at: Optional[Dict[str, Sequence[int]]] = None,
                 kill_at: Optional[Dict[str, Sequence[int]]] = None,
                 preempt_at: Optional[Dict[str, Sequence[int]]] = None,
                 preempt_rate: float = 0.0,
                 shrink_at: Optional[Dict[str, Sequence[int]]] = None,
                 shrink_to: int = 0,
                 grow_at: Optional[Dict[str, Sequence[int]]] = None,
                 grow_to: int = 0,
                 collective_mismatch: bool = False,
                 bitflip_at: int = -1, bitflip_rate: float = 0.0,
                 slow_from_step: int = -1, slow_rate: float = 0.0):
        refused = [name for name, asked in (
            ("truncate (truncate_rate / truncate_at, the corrupt hook)",
             truncate_rate > 0 or bool(truncate_at)),
            ("kill (kill_at)", bool(kill_at)),
            ("preempt (preempt_at / preempt_rate)", bool(preempt_at) or preempt_rate > 0),
            ("shrink / grow (shrink_at, grow_at)",
             bool(shrink_at) or bool(grow_at) or shrink_to > 0 or grow_to > 0),
            ("bitflip (bitflip_at / bitflip_rate)", bitflip_at >= 0 or bitflip_rate > 0),
            ("slow_device (slow_from_step / slow_rate)", slow_from_step >= 0 or slow_rate > 0),
            ("collective_mismatch", collective_mismatch)) if asked]
        if refused:
            raise NotImplementedError(f"chaos fault class(es) {refused}: {LATER}")
        scripted = {op for d in (fail_at, hang_at, delay_at) for op in (d or {})}
        unhooked = sorted((scripted | set(ops or ())) - HOOKED_OPS)
        if unhooked:
            raise NotImplementedError(f"chaos hook(s) {unhooked}: {LATER}")
        if (failure_rate > 0 or delay_rate > 0 or hang_rate > 0) and not ops:
            raise NotImplementedError(
                "a chaos rate without ops reaches the checkpoint I/O and step hooks in the "
                f"JAX package, which are {LATER}; pass ops=['decode_step']")
        self._rng = random.Random(seed)
        self.seed = seed
        self.source = "manual"      # "env": built from DS_CHAOS
        self.failure_rate = float(failure_rate)
        self.delay_rate = float(delay_rate)
        self.max_delay_s = float(max_delay_s)
        self.hang_rate = float(hang_rate)
        self.hang_s = float(hang_s)
        self.ops = set(ops) if ops else None
        self.fail_at = {k: set(v) for k, v in (fail_at or {}).items()}
        self.hang_at = {k: set(v) for k, v in (hang_at or {}).items()}
        self.delay_at = {k: set(v) for k, v in (delay_at or {}).items()}
        self._counts = defaultdict(int)
        self.log: list = []          # (op, action, path): what fired

    @classmethod
    def from_env(cls, spec: str) -> "ChaosInjector":
        """Parse a ``DS_CHAOS`` spec: comma-separated k=v pairs; ``ops`` is
        ``+``-separated."""
        kw: dict = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            k = k.strip()
            if k == "ops":
                kw["ops"] = [o for o in v.split("+") if o]
            elif k == "seed":
                kw["seed"] = int(v)
            else:
                kw[k] = float(v)
        return cls(**kw)

    def _applies(self, op: str) -> bool:
        return self.ops is None or op in self.ops

    def targets(self, op: str) -> bool:
        """Does any fault class aim at ``op``? The front-end's hook fires
        only when one does."""
        if self.ops is not None:
            return op in self.ops
        return any(op in d for d in (self.fail_at, self.hang_at, self.delay_at))

    def _count(self, op: str, action: str):
        from deepspeed_tpu_torch import telemetry

        telemetry.get_registry().counter(
            "resilience/chaos_injections", labels={"op": op, "action": action}).inc()

    def _hang(self, op: str, n: int, path: str):
        """Interruptible stall: sleep in 50 ms slices."""
        self.log.append((op, f"hang {self.hang_s:.1f}s", path))
        self._count(op, "hang")
        logger.warning(f"chaos: injected hang on {op} #{n} for {self.hang_s:.1f}s ({path})")
        deadline = time.monotonic() + self.hang_s
        while time.monotonic() < deadline:
            time.sleep(0.05)

    def before(self, op: str, path: str):
        """Called before an op runs; may sleep, hang, or raise ChaosError.
        The draws come in the JAX injector's order (hang, delay, fail)."""
        if not self._applies(op):
            return
        self._counts[op] += 1
        n = self._counts[op]
        if n in self.fail_at.get(op, ()):
            self.log.append((op, "fail", path))
            self._count(op, "fail")
            raise ChaosError(f"chaos: injected failure on {op} #{n} ({path})")
        rate_hang = self.hang_rate and self._rng.random() < self.hang_rate
        if n in self.hang_at.get(op, ()) or rate_hang:
            self._hang(op, n, path)
        if n in self.delay_at.get(op, ()):
            self.log.append((op, f"delay {self.max_delay_s:.3f}s", path))
            self._count(op, "delay")
            time.sleep(self.max_delay_s)
        if self.delay_rate and self._rng.random() < self.delay_rate:
            d = self._rng.uniform(0.0, self.max_delay_s)
            self.log.append((op, f"delay {d:.3f}s", path))
            self._count(op, "delay")
            time.sleep(d)
        if self.failure_rate and self._rng.random() < self.failure_rate:
            self.log.append((op, "fail", path))
            self._count(op, "fail")
            raise ChaosError(f"chaos: injected failure on {op} #{n} ({path})")


_installed: Optional[ChaosInjector] = None
_env_checked = False


def install_chaos(injector: ChaosInjector):
    global _installed
    logger.warning(f"chaos: fault injection ACTIVE (seed={injector.seed}, "
                   f"failure_rate={injector.failure_rate}, hang_rate={injector.hang_rate}, "
                   f"delay_rate={injector.delay_rate}, "
                   f"ops={sorted(injector.ops) if injector.ops else 'scripted'})")
    _installed = injector


def uninstall_chaos():
    global _installed, _env_checked
    _installed = None
    _env_checked = True      # an explicit uninstall also wins over DS_CHAOS


def uninstall_config_chaos():
    """Remove only a config-installed injector. The ``resilience.chaos``
    block is a later slice, so none is ever installed that way yet; kept
    for the JAX package's surface."""
    global _installed
    if _installed is not None and _installed.source == "config":
        _installed = None


def active_injector() -> Optional[ChaosInjector]:
    """The installed injector, else one built once from ``DS_CHAOS``."""
    global _env_checked, _installed
    if _installed is not None:
        return _installed
    if not _env_checked:
        _env_checked = True
        spec = os.environ.get("DS_CHAOS", "").strip()
        if spec and spec not in ("0", "off", "false"):
            inj = ChaosInjector.from_env(spec)
            inj.source = "env"
            install_chaos(inj)
    return _installed
