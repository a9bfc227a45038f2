"""Seedable fault injection for the checkpoint I/O path, the training step
and the serving tick.

Counterpart of ``deepspeed_tpu/resilience/chaos.py``. The checkpoint engine
routes every file write through ``injector.before(op, path)`` (may raise
:class:`ChaosError`, sleep, hang, or kill the process) and
``injector.corrupt(op, path, data)`` (may truncate the payload, a silent
fault only the manifest check catches); its ops are ``state_save``,
``client_state``, ``sampler_sidecar``, ``manifest``, ``latest`` and the
rewind ladder's ``emergency_save``. The training engine calls
``before("train_step", ...)`` at each step before any launch, and the
serving front-end ``before("decode_step", request_id)`` at each tick; both
fire only when :meth:`ChaosInjector.targets` says a fault aims there. The
fault classes, scripted per call count (1-based, per op) or drawn per call
from one ``random.Random(seed)`` stream in the JAX order, so a seed and a
script give the JAX injector's sequence:

* ``fail`` (``fail_at`` / ``failure_rate``): raise :class:`ChaosError`;
* ``hang`` (``hang_at`` / ``hang_rate``): stall ``hang_s`` seconds in an
  interruptible sleep loop, which the step watchdog or the tick's deadline
  cuts short; a rate without ``ops`` reaches the step and tick hooks only;
* ``delay`` (``delay_at`` sleeps ``max_delay_s``; ``delay_rate`` a uniform
  draw up to it): latency, not a hang;
* ``truncate`` (``truncate_at`` / ``truncate_rate``, the ``corrupt``
  hook): the write succeeds with a prefix of the payload;
* ``kill`` (``kill_at``): SIGKILL the process: only the launcher's
  supervision notices;
* ``preempt`` (``preempt_at`` / ``preempt_rate``, the rate on the step and
  tick hooks only without ``ops``): SIGTERM to this process, what a
  preemption notice sends; the elastic agent's handler sets its flag and
  the run stops at the next step boundary with an emergency save.

The fault classes of several devices (shrink/grow, bitflip, slow_device,
collective_mismatch) and the ``collective`` hook belong to a later slice:
naming one raises ``NotImplementedError`` in the constructor.

Activation: :func:`install_chaos` (tests, drills), the
``resilience.chaos`` ds_config block at engine init, or the ``DS_CHAOS``
environment variable, e.g. ``DS_CHAOS="seed=7,failure_rate=0.2,
truncate_rate=0.1,ops=latest+client_state"`` (``ops`` is ``+``-separated).
"""

from __future__ import annotations

import os
import random
import signal
import sys
import time
from collections import defaultdict
from typing import Dict, Iterable, Optional, Sequence

from deepspeed_tpu_torch.utils.logging import logger

LATER = "a later slice of the port (it needs several devices or a simulated mesh)"
# the hooks a rate without ops reaches, as in JAX
STEP_HOOKS = ("train_step", "decode_step")


class ChaosError(OSError):
    """An injected fault (an OSError, as the flaky I/O it stands in for, so
    retry policies treat it alike)."""


class ChaosInjector:
    """Deterministic fault plan: scripted (``fail_at={"latest": [1, 2]}``
    fails the 1st and 2nd ``latest`` write, ``truncate_at={"client_state":
    [1]}`` truncates the 1st client_state payload) and/or randomized (the
    ``*_rate`` knobs draw per call from ``random.Random(seed)``). ``ops``
    restricts injection to the ops it names (None: all)."""

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
                 collective_mismatch_rank: int = -1,
                 bitflip_at: int = -1, bitflip_rate: float = 0.0,
                 bitflip_target: str = "params", bitflip_device: int = 0,
                 bitflip_bit: int = 12,
                 slow_from_step: int = -1, slow_device: int = 0,
                 slow_factor: float = 1.0, slow_rate: float = 0.0,
                 slow_min_s: float = 0.0, slow_kind: str = "compute"):
        refused = [name for name, asked in (
            ("shrink / grow (shrink_at, grow_at)",
             bool(shrink_at) or bool(grow_at) or shrink_to > 0 or grow_to > 0),
            ("bitflip (bitflip_at / bitflip_rate)", bitflip_at >= 0 or bitflip_rate > 0),
            ("slow_device (slow_from_step / slow_rate)", slow_from_step >= 0 or slow_rate > 0),
            ("collective_mismatch", collective_mismatch)) if asked]
        if refused:
            raise NotImplementedError(f"chaos fault class(es) {refused}: {LATER}")
        scripted = {op for d in (fail_at, truncate_at, hang_at, delay_at, kill_at, preempt_at)
                    for op in (d or {})}
        if "collective" in scripted | set(ops or ()):
            raise NotImplementedError(f"chaos hook 'collective': {LATER}")
        self._rng = random.Random(seed)
        self.seed = seed
        self.source = "manual"      # "config" / "env": who installed it
        self.failure_rate = float(failure_rate)
        self.truncate_rate = float(truncate_rate)
        self.delay_rate = float(delay_rate)
        self.max_delay_s = float(max_delay_s)
        self.hang_rate = float(hang_rate)
        self.hang_s = float(hang_s)
        self.ops = set(ops) if ops else None
        self.fail_at = {k: set(v) for k, v in (fail_at or {}).items()}
        self.truncate_at = {k: set(v) for k, v in (truncate_at or {}).items()}
        self.hang_at = {k: set(v) for k, v in (hang_at or {}).items()}
        self.delay_at = {k: set(v) for k, v in (delay_at or {}).items()}
        self.kill_at = {k: set(v) for k, v in (kill_at or {}).items()}
        self.preempt_at = {k: set(v) for k, v in (preempt_at or {}).items()}
        self.preempt_rate = float(preempt_rate)
        self._counts = defaultdict(int)
        self.log: list = []          # (op, action, path): what fired

    @classmethod
    def from_config(cls, cfg) -> "ChaosInjector":
        """Built from the ``resilience.chaos`` block (``ResilienceChaosConfig``),
        whose fault classes of several devices are refused there."""
        inj = cls(seed=cfg.seed, failure_rate=cfg.failure_rate,
                  truncate_rate=cfg.truncate_rate, delay_rate=cfg.delay_rate,
                  max_delay_s=cfg.max_delay_s, hang_rate=cfg.hang_rate, hang_s=cfg.hang_s,
                  ops=cfg.ops or None, preempt_rate=cfg.preempt_rate)
        inj.source = "config"
        return inj

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
        """Does any fault class aim at ``op``? The step and tick hooks fire
        only when one does: a checkpoint-I/O drill (rates, no ``ops``) must
        not spread into the step path, except the step-oriented hang and
        preempt rates."""
        if self.ops is not None:
            return op in self.ops
        if any(op in d for d in (self.fail_at, self.truncate_at, self.hang_at,
                                 self.delay_at, self.kill_at, self.preempt_at)):
            return True
        return self.hang_rate > 0 or self.preempt_rate > 0

    def _count(self, op: str, action: str):
        from deepspeed_tpu_torch import telemetry

        telemetry.get_registry().counter(
            "resilience/chaos_injections", labels={"op": op, "action": action}).inc()
        bb = sys.modules.get("deepspeed_tpu_torch.blackbox")
        if bb is not None:
            # chaos is self-inflicted: context for the timeline, never a
            # trigger of its own
            bb.record("chaos_injection", "warning", {"op": op, "action": action})

    def _hang(self, op: str, n: int, path: str):
        """Interruptible stall: sleep in 50 ms slices, so an asynchronous
        ``WatchdogTimeout`` lands between them."""
        self.log.append((op, f"hang {self.hang_s:.1f}s", path))
        self._count(op, "hang")
        logger.warning(f"chaos: injected hang on {op} #{n} for {self.hang_s:.1f}s ({path})")
        deadline = time.monotonic() + self.hang_s
        while time.monotonic() < deadline:
            time.sleep(0.05)

    def _signal(self, op: str, n: int, path: str, action: str, sig) -> None:
        self.log.append((op, action, path))
        self._count(op, action)
        logger.warning(f"chaos: injected {sig.name} ({action}) on {op} #{n} ({path})")
        os.kill(os.getpid(), sig)

    def before(self, op: str, path: str):
        """Called before an op runs; may sleep, hang, kill or preempt the
        process, or raise ChaosError. The draws come in the JAX injector's
        order."""
        if not self._applies(op):
            return
        self._counts[op] += 1
        n = self._counts[op]
        if n in self.fail_at.get(op, ()):
            self.log.append((op, "fail", path))
            self._count(op, "fail")
            raise ChaosError(f"chaos: injected failure on {op} #{n} ({path})")
        if n in self.kill_at.get(op, ()):
            self._signal(op, n, path, "kill", signal.SIGKILL)
        # preempt: SIGTERM to self; the agent's handler sets its flag and
        # returns, so the step completes and the run stops at the boundary
        rate_preempt = (self.preempt_rate and (self.ops is not None or op in STEP_HOOKS)
                        and self._rng.random() < self.preempt_rate)
        if n in self.preempt_at.get(op, ()) or rate_preempt:
            self._signal(op, n, path, "preempt", signal.SIGTERM)
        # a hang rate without ops stays on the step hooks, where a deadline
        # is armed (JAX's list also names its collective hook)
        rate_hang = (self.hang_rate and (self.ops is not None or op in (*STEP_HOOKS, "collective"))
                     and self._rng.random() < self.hang_rate)
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

    def corrupt_len(self, op: str, path: str, nbytes: int) -> int:
        """How many of a payload's ``nbytes`` the write keeps: all of them,
        or a truncation drawn as :meth:`corrupt` draws it (a streamed write
        asks after writing and truncates its file)."""
        if not self._applies(op) or not nbytes:
            return nbytes
        n = self._counts[op]
        scripted = n in self.truncate_at.get(op, ())
        randomized = self.truncate_rate and self._rng.random() < self.truncate_rate
        if scripted or randomized:
            cut = self._rng.randrange(0, max(1, nbytes))
            self.log.append((op, f"truncate {nbytes}→{cut}B", path))
            self._count(op, "truncate")
            return cut
        return nbytes

    def corrupt(self, op: str, path: str, data: bytes) -> bytes:
        """The payload about to be written, or a prefix of it: the write
        then succeeds with bad content, which only the manifest check at
        load time catches."""
        if not data:
            return data
        return data[:self.corrupt_len(op, path, len(data))]


_installed: Optional[ChaosInjector] = None
_env_checked = False


def install_chaos(injector: ChaosInjector):
    global _installed
    logger.warning(f"chaos: fault injection ACTIVE (seed={injector.seed}, "
                   f"failure_rate={injector.failure_rate}, "
                   f"truncate_rate={injector.truncate_rate}, "
                   f"delay_rate={injector.delay_rate}, "
                   f"ops={sorted(injector.ops) if injector.ops else 'all'})")
    _installed = injector


def uninstall_chaos():
    global _installed, _env_checked
    _installed = None
    _env_checked = True      # an explicit uninstall also wins over DS_CHAOS


def uninstall_config_chaos():
    """Remove only a config-installed injector: an engine built without an
    enabled ``resilience.chaos`` block does not inherit an earlier engine's
    drill, and leaves a ``DS_CHAOS`` or manual install alone."""
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
