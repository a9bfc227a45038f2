"""The request lifecycle manager: admission, deadlines, breaker, drain.

Counterpart of ``deepspeed_tpu/serving/frontend.py``. One worker thread
pulls admitted requests off a bounded queue and drives each through a
prefill tick and decode ticks of ``decode_tick_tokens`` tokens, over the
engine's :class:`~deepspeed_tpu_torch.inference.engine.ServingLoop` of the
request's sampling key (the decode step ``generate`` captures, replayed on
the card). Every tick runs under the watchdog's ``run_with_deadline``, so
a hung step, or an injected chaos ``decode_step`` hang, becomes a clean
per-request timeout instead of a wedged server, and the host checks the
request's deadline, the drain flag and the agent's preemption flag between
ticks.

The invariant: **an admitted request reaches exactly one terminal status**
(completed / partial / shed / failed), and the reason travels with it.
Overload sheds at admission with a structured
:class:`~deepspeed_tpu_torch.serving.admission.ShedError`; engine sickness
opens the circuit breaker (queued requests shed with retry-after,
readiness → degraded, a probe half-opens it after the cooldown);
SIGTERM or preemption drains (admission stops, the request in flight
finishes or is deadline-capped, streaming consumers get their partials)
and the process exits with :data:`DRAIN_EXIT_CODE` (87), which the
launcher tells apart from a crash.

Health states: ``starting → ready ⇄ degraded → draining → dead``.

Ticks on the card. A tick runs on a fresh ``ds-deadline-*`` thread, so the
tick body sets the engine's device and enters ``inference_mode`` itself
(both are per thread) and launches on that thread's default stream, the
stream ``generate`` uses: the decode kernel's merge semaphores are shared
per device, and the legacy default stream orders the launches of every
thread. The first decode tick of a key captures its graph on the tick
thread (``capture_error_mode="thread_local"``).

The disowned-tick rule. The JAX programs take no donated buffers, so a
tick abandoned at its deadline computes on arrays of its own. The port's
decode loop writes static buffers in place, so a tick that times out or
raises costs its key's loop: the front-end drops it (the disowned thread
holds the only reference to those buffers), forgets the key's warm ticks
(the next capture gets the startup cap) and builds a new loop for the
next request of that key. The tick body also checks its tick's abandoned
flag after the chaos hook, before any launch.

With the flight recorder armed (``blackbox.configure``; serving has no
ds_config key that arms it, as in JAX), every state transition, shed at
the door and shed after admission is an event in its ring
(``serving_transition``, ``shed``, ``shed_admitted``), recorded through
``sys.modules`` so an unarmed server never imports the package.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import signal
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import telemetry as _telemetry
from deepspeed_tpu_torch.launcher.launch import DRAIN_EXIT_CODE  # noqa: F401 (re-exported)
from deepspeed_tpu_torch.resilience.watchdog import WatchdogTimeout, run_with_deadline
from deepspeed_tpu_torch.serving.admission import Request, ShedError, resolve_capacity
from deepspeed_tpu_torch.serving.breaker import CLOSED, OPEN, CircuitBreaker
from deepspeed_tpu_torch.utils import locks as _locks
from deepspeed_tpu_torch.utils.logging import logger

STATUS_FILE = "serving_status.json"


class ServerState:
    """Health/readiness states, with stable numeric codes for the
    ``serving/state`` gauge (a gauge cannot carry a string)."""
    STARTING = "starting"
    READY = "ready"
    DEGRADED = "degraded"
    DRAINING = "draining"
    DEAD = "dead"
    CODES = {STARTING: 0, READY: 1, DEGRADED: 2, DRAINING: 3, DEAD: 4}


class ServingFrontEnd:
    """Fault-tolerant serving wrapper around an
    :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`.

    ``cfg`` is the ``serving`` ds_config block (``ServingConfig``);
    ``agent`` (optional) is a
    :class:`~deepspeed_tpu_torch.elasticity.elastic_agent.DSElasticAgent`
    whose ``preempted`` flag triggers a drain; ``start=False`` defers the
    worker thread (tests fill the queue first, then :meth:`start`)."""

    WORKER_POLL_S = 0.02

    def __init__(self, engine, cfg=None, agent=None, start: bool = True,
                 status_dir: Optional[str] = None):
        if cfg is None:
            from deepspeed_tpu_torch.runtime.config import ServingConfig
            cfg = ServingConfig()
        if not cfg.enabled:
            raise ValueError("serving.enabled is false — the front-end "
                             "refuses to serve a config that opted out")
        self.engine = engine
        self.cfg = cfg
        self.agent = agent
        rlock = _locks.make_rlock("serving.frontend")  # ONE lock: queue + breaker
        self._lock = _locks.make_condition("serving.frontend", rlock)
        self._queue: collections.deque = collections.deque()
        self._in_flight: Optional[Request] = None
        self.capacity, self.capacity_detail = resolve_capacity(engine, cfg)
        self.breaker = CircuitBreaker(
            threshold=cfg.breaker_threshold, cooldown_s=cfg.breaker_cooldown_s,
            on_transition=self._on_breaker, lock=rlock)
        self._state = ServerState.STARTING
        self._draining = False
        self._drain_reason = ""
        self._drain_deadline: Optional[float] = None
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        # sampling key -> its ServingLoop; None: a variant whose loop was
        # dropped (a disowned tick), built again at its next request
        self._programs: Dict[tuple, Any] = {}
        self._warm: Dict[tuple, int] = {}    # tick key -> successful runs
        self._service_ema: Optional[float] = None
        self.counts: Dict[str, float] = collections.defaultdict(float)
        self.exit_code = 0
        self._status_dir = status_dir
        self._req_seq = 0
        self._set_state_gauge()
        self._reg().gauge("serving/capacity").set(self.capacity)
        if start:
            self.start()

    # -------------------------------------------------------------- telemetry
    @staticmethod
    def _reg():
        return _telemetry.get_registry()

    def _count(self, name: str, labels: Optional[Dict[str, str]] = None,
               n: float = 1.0) -> None:
        key = name if not labels else \
            name + "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"
        self.counts[key] += n
        self._reg().counter(f"serving/{name}", labels=labels).inc(n)

    def _set_queue_gauge(self) -> None:
        depth = len(self._queue) + (1 if self._in_flight is not None else 0)
        self._reg().gauge("serving/queue_depth").set(depth)

    def _set_state_gauge(self) -> None:
        self._reg().gauge("serving/state").set(ServerState.CODES[self._state])

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "ServingFrontEnd":
        with self._lock:
            if self._worker is not None and self._worker.is_alive():
                return self
            self._worker = _locks.spawn_thread(self._serve_loop,
                                               name="ds-serve-worker",
                                               owner="serving", daemon=True)
            self._worker.start()
            if self._state == ServerState.STARTING:
                self._transition(ServerState.READY)
        return self

    def _transition(self, to: str) -> None:
        with self._lock:
            frm = self._state
            if frm == to or frm == ServerState.DEAD:
                return
            self._state = to
            self._count("state_transitions", labels={"from": frm, "to": to})
            self._set_state_gauge()
            logger.info(f"serving state: {frm} -> {to}"
                        + (f" ({self._drain_reason})" if to == ServerState.DRAINING else ""))
            bb = sys.modules.get("deepspeed_tpu_torch.blackbox")
            if bb is not None:
                degraded = to in (ServerState.DRAINING, ServerState.DEGRADED, ServerState.DEAD)
                bb.record("serving_transition", "warning" if degraded else "info",
                          {"from": frm, "to": to,
                           "reason": self._drain_reason if to == ServerState.DRAINING
                           else None})
        self._write_status()

    @property
    def state(self) -> str:
        return self._state

    def install_signal_handlers(self) -> bool:
        """SIGTERM/SIGINT → graceful drain (main thread only). The handler
        only sets flags — the worker does the draining — so it is
        async-signal-safe in the Python sense."""
        def _on_signal(signum, frame):
            logger.warning(f"serving: received signal {signum} — draining")
            self.begin_drain("signal")

        try:
            signal.signal(signal.SIGTERM, _on_signal)
            signal.signal(signal.SIGINT, _on_signal)
            return True
        except ValueError:
            logger.warning("serving: cannot install signal handlers outside "
                           "the main thread; use begin_drain()/attach an agent")
            return False

    # -------------------------------------------------------------- admission
    def submit(self, prompt, max_new_tokens: int = 32,
               deadline_s: Optional[float] = None, stream=None,
               request_id: Optional[str] = None, do_sample: bool = False,
               temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
               eos_token_id: Optional[int] = None, seed: int = 0,
               is_probe: bool = False) -> Request:
        """Admit a request or raise :class:`ShedError`. Admission is where
        load shedding happens EARLY — a request whose estimated TTFT
        already blows its deadline is refused now, not decoded into a
        guaranteed timeout later."""
        ids = np.asarray(prompt, dtype=np.int32)
        if ids.ndim == 1:
            ids = ids[None, :]
        if ids.ndim != 2 or ids.shape[0] != 1:
            raise ValueError(f"serving requests are single-sequence: prompt "
                             f"shape {ids.shape} (batching is the scheduler's "
                             "job, not the client's)")
        total = ids.shape[1] + int(max_new_tokens)
        max_len = int(self.engine._config.max_out_tokens)
        if total > max_len:
            raise ValueError(f"prompt {ids.shape[1]} + max_new_tokens "
                             f"{max_new_tokens} exceeds max_out_tokens {max_len}")
        deadline = float(deadline_s) if deadline_s is not None \
            else float(self.cfg.default_deadline_s)
        pkey = (bool(do_sample), float(temperature), int(top_k),
                float(top_p), eos_token_id)
        with self._lock:
            # sampling params are CLIENT-controlled jit cache keys: each
            # new combination costs a multi-second compile (serializing
            # the worker) and pins a program forever — bound them, and
            # say no with structure instead of compiling forever. The
            # bound counts compiled programs PLUS the distinct variants
            # already admitted (queued/in-flight) — a burst of unique
            # variants queued before the worker compiles any must not
            # slip past a compiled-only check.
            known = set(self._programs)
            known.update(self._program_key(r) for r in self._queue)
            if self._in_flight is not None:
                known.add(self._program_key(self._in_flight))
            if pkey not in known and \
                    len(known) >= int(self.cfg.max_program_variants):
                self._shed_count("sampling_variant_limit")
                raise ShedError("sampling_variant_limit",
                                queue_depth=len(self._queue),
                                retry_after_s=self.cfg.shed_retry_after_s)
            if self._state in (ServerState.DRAINING, ServerState.DEAD):
                self._shed_count("draining")
                raise ShedError("draining",
                                queue_depth=len(self._queue),
                                retry_after_s=self.cfg.shed_retry_after_s)
            depth = len(self._queue) + (1 if self._in_flight is not None else 0)
            if depth >= self.capacity:
                self._shed_count("queue_full")
                raise ShedError(
                    "queue_full", queue_depth=depth,
                    est_wait_s=depth * (self._service_ema or 0.0),
                    retry_after_s=self.cfg.shed_retry_after_s)
            if self._service_ema is not None:
                est_ttft = (depth + 0.5) * self._service_ema
                if est_ttft > deadline:
                    self._shed_count("deadline_unreachable")
                    raise ShedError("deadline_unreachable", queue_depth=depth,
                                    est_wait_s=est_ttft,
                                    retry_after_s=self.cfg.shed_retry_after_s)
            # breaker LAST: admits() in half-open claims the single probe
            # slot, so no later check may shed the request after it
            ok, retry_after = self.breaker.admits()
            if not ok:
                self._shed_count("circuit_open")
                raise ShedError("circuit_open", queue_depth=len(self._queue),
                                retry_after_s=retry_after)
            self._req_seq += 1
            req = Request(prompt=ids, max_new_tokens=int(max_new_tokens),
                          deadline_s=deadline,
                          id=request_id or f"req-{self._req_seq}-{uuid.uuid4().hex[:6]}",
                          stream=stream, do_sample=bool(do_sample),
                          temperature=float(temperature), top_k=int(top_k),
                          top_p=float(top_p), eos_token_id=eos_token_id,
                          seed=int(seed), is_probe=is_probe)
            req.submitted_at = time.monotonic()
            self._queue.append(req)
            self._count("admitted")
            self._set_queue_gauge()
            self._lock.notify_all()
        return req

    def probe(self, timeout: Optional[float] = 30.0) -> Request:
        """A minimal synthetic request (1 prompt token, 1 new token) —
        what half-opens an open circuit after its cooldown."""
        req = self.submit(np.zeros((1, 1), np.int32), max_new_tokens=1,
                          deadline_s=timeout, is_probe=True)
        return req.result(timeout=timeout)

    def _shed_count(self, reason: str) -> None:
        self._count("shed", labels={"reason": reason})
        bb = sys.modules.get("deepspeed_tpu_torch.blackbox")
        if bb is not None:
            bb.record("shed", "warning", {"reason": reason})

    def _resolve_shed(self, req: Request, reason: str,
                      retry_after_s: float = 0.0) -> None:
        """Resolve an ALREADY-ADMITTED request as shed (drain/circuit-open
        empty the queue this way; clients see status='shed' + reason +
        the retry-after back-off hint). Counted as ``shed_admitted`` — a
        DIFFERENT series from the at-the-door ``shed`` refusals, so the
        ledger reconciliation `admitted == completed + timed_out + drained
        + failed + Σ shed_admitted` stays checkable from the JSONL."""
        self._count("shed_admitted", labels={"reason": reason})
        bb = sys.modules.get("deepspeed_tpu_torch.blackbox")
        if bb is not None:
            bb.record("shed_admitted", "warning",
                      {"reason": reason, "retry_after_s": retry_after_s})
        req.retry_after_s = float(retry_after_s)
        self._resolve(req, "shed", reason)

    # ------------------------------------------------------------ breaker cb
    def _on_breaker(self, frm: str, to: str) -> None:
        # runs under the shared lock (see CircuitBreaker.__init__)
        self._count("circuit_transitions", labels={"from": frm, "to": to})
        if to == OPEN:
            while self._queue:
                self._resolve_shed(self._queue.popleft(), "circuit_open",
                                   retry_after_s=self.cfg.breaker_cooldown_s)
            self._set_queue_gauge()
            if self._state == ServerState.READY:
                self._transition(ServerState.DEGRADED)
        elif to == CLOSED and self._state == ServerState.DEGRADED:
            self._transition(ServerState.READY)

    # ----------------------------------------------------------------- drain
    @_locks.signal_safe("runs on the main thread (Python delivers signals "
                        "there); the shared serving.frontend RLock is "
                        "reentrant, so interrupting a lock-holding submit() "
                        "re-enters instead of deadlocking, and the handler "
                        "only flips flags + sheds the queue — the worker "
                        "does the actual draining")
    def begin_drain(self, reason: str = "signal") -> None:
        """Stop admission, shed the queue, deadline-cap the in-flight
        request at ``drain_grace_s``, then die. Idempotent."""
        with self._lock:
            if self._draining or self._state == ServerState.DEAD:
                return
            self._draining = True
            self._drain_reason = reason
            self._drain_deadline = time.monotonic() + float(self.cfg.drain_grace_s)
            self._transition(ServerState.DRAINING)
            while self._queue:
                self._resolve_shed(self._queue.popleft(), "draining",
                                   retry_after_s=self.cfg.shed_retry_after_s)
            self._set_queue_gauge()
            self._lock.notify_all()

    def drain(self, timeout: Optional[float] = None) -> int:
        """Wait for the drain to complete (worker exited, state dead);
        returns the exit code the process should use —
        :data:`DRAIN_EXIT_CODE` for a signal/preemption drain, 0 for a
        programmatic shutdown."""
        w = self._worker
        if w is not None:
            w.join(timeout)
        return self.exit_code

    def close(self) -> None:
        """Hard-ish stop for tests/embedding: drain with zero grace and
        stop the worker. The worker is a daemon, so a tick wedged past
        its deadline cannot block interpreter exit."""
        with self._lock:
            self.cfg = dataclasses.replace(self.cfg, drain_grace_s=0.0)
            self.begin_drain("closed")
        self._stop.set()
        with self._lock:
            self._lock.notify_all()
        w = self._worker
        if w is not None:
            w.join(timeout=5.0)

    def _poll_preempt(self) -> None:
        if self.agent is not None and getattr(self.agent, "preempted", False) \
                and not self._draining:
            logger.warning("serving: elastic agent reports preemption — draining")
            self.begin_drain("preemption")

    # ---------------------------------------------------------------- worker
    def _serve_loop(self) -> None:
        try:
            while True:
                self._poll_preempt()
                req = None
                with self._lock:
                    if self._queue:
                        req = self._queue.popleft()
                        self._in_flight = req
                        self._set_queue_gauge()
                    elif self._draining or self._stop.is_set():
                        break
                    else:
                        self._lock.wait(self.WORKER_POLL_S)
                        continue
                try:
                    self._process(req)
                finally:
                    with self._lock:
                        if not req.done:    # a BaseException escaped
                            # _process (SystemExit from a tick, async
                            # interrupt): the client must still get a
                            # terminal answer, not block forever
                            self._count("failed")
                            self._resolve(req, "failed", "worker_dead")
                        self._in_flight = None
                        self._set_queue_gauge()
                self._write_status()
        except BaseException as e:      # noqa: BLE001 - last line of defense
            logger.error(f"serving worker died: {type(e).__name__}: {e}")
            with self._lock:
                while self._queue:
                    self._resolve_shed(self._queue.popleft(), "worker_dead")
            raise
        finally:
            with self._lock:
                if self._drain_reason in ("signal", "preemption"):
                    self.exit_code = DRAIN_EXIT_CODE
                self._transition(ServerState.DEAD)

    # ----------------------------------------------------------- the request
    def _program_key(self, req: Request) -> tuple:
        # must mirror the pkey submit() builds for the variant bound:
        # Request construction coerces each field to the same type
        return (req.do_sample, req.temperature, req.top_k, req.top_p,
                req.eos_token_id)

    def _get_programs(self, req: Request):
        """The request's sampling key's ServingLoop, built at first use."""
        key = self._program_key(req)
        if self._programs.get(key) is None:
            self._programs[key] = self.engine.serving_loop(
                int(self.cfg.decode_tick_tokens), do_sample=req.do_sample,
                temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
                eos_token_id=req.eos_token_id)
        return self._programs[key]

    def _drop_loop(self, key: tuple) -> None:
        """A tick of ``key`` timed out or raised: its loop's buffers may
        still be written by the disowned thread, so the loop goes (the
        variant stays known to the admission bound) and the key's ticks are
        cold again, so the next capture gets the startup cap."""
        if key in self._programs:
            self._programs[key] = None
        for wk in [wk for wk in self._warm if wk[1] == key]:
            del self._warm[wk]

    def _tick(self, req: Request, fn, warm_key: tuple):
        """Run one tick (prefill or a decode chunk) under a hard deadline.
        The chaos ``decode_step`` hook runs inside the deadline, so an
        injected hang trips it exactly like a hung card. Raises
        WatchdogTimeout (tick cap / hung step) or _RequestDeadline (the
        request's own budget, drain cap)."""
        now = time.monotonic()
        remaining = req.deadline_at - now
        if self._draining and self._drain_deadline is not None:
            remaining = min(remaining, self._drain_deadline - now)
        if remaining <= 0:
            raise _RequestDeadline()
        # a tick is "warm" once its key has run: JAX specializes prefill per
        # prompt length and the decode chunk twice (call #1 on prefill's
        # outputs, #2+ on its own), and the keys stay JAX's. The port needs
        # less: prefill runs eagerly (nothing to build per length), and a
        # key's decode graph is captured once, on the first decode tick
        # after its loop was built. Until a key has run, the startup cap
        # applies: a capture must never read as a hang.
        cold = not self._warm.get(warm_key)
        cap = float(self.cfg.startup_tick_timeout_s) if cold \
            else float(self.cfg.decode_tick_timeout_s)
        budget = max(0.01, min(cap, remaining))
        abandoned = threading.Event()
        device = self.engine.device

        def run():
            from deepspeed_tpu_torch.resilience.chaos import active_injector

            inj = active_injector()
            if inj is not None and inj.targets("decode_step"):
                inj.before("decode_step", req.id)
            if abandoned.is_set():
                # the caller gave up on this tick: launch nothing
                raise _RequestDeadline()
            on_card = torch.cuda.device(device) if device.type == "cuda" \
                else contextlib.nullcontext()
            with on_card, torch.inference_mode():
                return fn()

        phase = str(warm_key[0])        # "prefill" | "decode"
        t_tick = time.monotonic()
        try:
            # request-scoped span: with the admission_wait span it splits
            # TTFT into queue wait and compute, per request
            with _telemetry.get_tracer().span(phase, cat="serving", request=req.id):
                # a tick bound by the request's budget (budget < cap) that
                # expires is a deadline over healthy compute, not a hang
                out = run_with_deadline(run, timeout=budget,
                                        name=f"serve-tick[{req.id}]",
                                        stall_span=budget >= cap)
        except WatchdogTimeout:
            abandoned.set()
            self._drop_loop(warm_key[1])
            if budget < cap:
                # the request's own budget (or the drain cap) was binding:
                # a deadline, not a hang
                raise _RequestDeadline() from None
            raise
        except Exception:
            self._drop_loop(warm_key[1])
            raise
        self._reg().histogram(
            f"serving/{'prefill' if phase == 'prefill' else 'decode_chunk'}"
            "_seconds").observe(time.monotonic() - t_tick)
        self._warm[warm_key] = self._warm.get(warm_key, 0) + 1
        # "K consecutive decode-step failures" is tick-granular: every
        # healthy tick resets the streak, and a working tick is what
        # closes a half-open circuit
        self.breaker.record_success()
        return out

    def _process(self, req: Request) -> None:
        req.started_at = time.monotonic()
        req.status = "running"
        reg = self._reg()
        wait_s = req.started_at - req.submitted_at
        reg.histogram("serving/queue_wait_seconds").observe(wait_s)
        # the admission wait as a complete span ending now: the first leg
        # of the request-scoped admission_wait -> prefill -> decode chain
        _telemetry.get_tracer().complete("admission_wait", wait_s * 1e6,
                                         cat="serving", request=req.id)
        eos = 0 if req.eos_token_id is None else max(int(req.eos_token_id), 0)
        pkey = self._program_key(req)
        try:
            loop = self._get_programs(req)
            ids = torch.from_numpy(np.asarray(req.prompt, dtype=np.int64))
            device = self.engine.device
            self._tick(req, lambda: loop.prefill(ids.to(device), req.seed),
                       warm_key=("prefill", pkey, ids.shape[1]))
            chunk_i = 0
            while len(req.tokens) < req.max_new_tokens:
                self._poll_preempt()
                left = req.max_new_tokens - len(req.tokens)
                fresh, done = self._tick(
                    req, lambda: loop.decode_chunk(left),
                    warm_key=("decode", pkey, min(chunk_i, 1)))
                chunk_i += 1
                req.tokens.extend(fresh)
                self._count("tokens_streamed", n=len(fresh))
                if req.ttft_s is None:
                    req.ttft_s = time.monotonic() - req.submitted_at
                    reg.histogram("serving/ttft_seconds").observe(req.ttft_s)
                    reg.histogram("serving/ttft_deadline_fraction").observe(
                        req.ttft_s / req.deadline_s)
                self._flush_stream(req, fresh)
                if done:
                    # parity with generate(): post-EOS positions hold EOS
                    pad = req.max_new_tokens - len(req.tokens)
                    if pad > 0:
                        req.tokens.extend([eos] * pad)
                        self._flush_stream(req, [eos] * pad)
                    break
            self._observe_service(req)
            self._count("completed")
            self._resolve(req, "completed", "")
        except _RequestDeadline:
            # the request ran out of ITS budget; every tick that ran was
            # healthy, so the breaker hears nothing. The ledger counts by
            # terminal REASON class (completed / timed_out / drained /
            # failed / shed_admitted) — exactly one per resolution, so
            # `admitted == their sum` is checkable from the JSONL.
            reason = "drained" if self._draining else "deadline"
            if req.tokens or req.ttft_s is not None:
                self._count("drained" if self._draining else "timed_out")
                self._resolve(req, "partial", reason)
            else:
                # expired before producing anything — a late shed, honest
                # about the fact that no work reached the client
                self._resolve_shed(req, reason,
                                   retry_after_s=self.cfg.shed_retry_after_s)
        except WatchdogTimeout as e:
            # a tick blew its cap with request budget left: the ENGINE
            # hung, not the request — breaker counts it
            self.breaker.record_failure()
            self._count("timed_out")
            logger.error(f"serving: hung tick on {req.id}: {e}")
            self._resolve(req, "partial" if req.tokens else "failed", "timeout")
        except Exception as e:      # noqa: BLE001 - resolved, never dropped
            self.breaker.record_failure()
            self._count("failed")
            logger.error(f"serving: request {req.id} failed: "
                         f"{type(e).__name__}: {e}")
            self._resolve(req, "partial" if req.tokens else "failed",
                          f"error: {type(e).__name__}: {e}")
        finally:
            # a probe that ended with NO tick verdict (expired in queue,
            # drain-capped before its first tick) must hand the half-open
            # slot back, or the breaker wedges in half_open forever
            self.breaker.release_probe()

    def _flush_stream(self, req: Request, toks: List[int]) -> None:
        if req.stream is None or not toks:
            return
        try:
            req.stream(list(toks))
        except Exception as e:      # noqa: BLE001 - a broken consumer must not kill serving
            logger.warning(f"serving: stream consumer for {req.id} raised: {e}")

    def _observe_service(self, req: Request) -> None:
        dur = time.monotonic() - req.started_at
        self._service_ema = dur if self._service_ema is None \
            else 0.8 * self._service_ema + 0.2 * dur
        reg = self._reg()
        reg.histogram("serving/request_seconds").observe(
            time.monotonic() - req.submitted_at)
        reg.histogram("serving/tokens_per_request").observe(len(req.tokens))

    def _resolve(self, req: Request, status: str, reason: str) -> None:
        # no status-file write here: resolutions can happen in bulk under
        # the admission lock (a drain shedding the whole queue) — the
        # worker writes once per served request, transitions once each
        req.status = status
        req.reason = reason
        req.finished_at = time.monotonic()
        req._done.set()

    # ---------------------------------------------------------------- status
    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self._state,
                "queue_depth": len(self._queue),
                "in_flight": self._in_flight.id if self._in_flight else None,
                "capacity": self.capacity,
                "capacity_detail": dict(self.capacity_detail),
                "breaker": self.breaker.state,
                "draining": self._draining,
                "drain_reason": self._drain_reason,
                "service_ema_s": self._service_ema,
                "counts": dict(self.counts),
            }

    def _status_path(self) -> Optional[str]:
        if self._status_dir:
            return os.path.join(self._status_dir, STATUS_FILE)
        s = _telemetry.get_session()
        if s is not None:
            return os.path.join(s.output_dir, STATUS_FILE)
        return None

    def _write_status(self) -> None:
        path = self._status_path()
        if path is None:
            return
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            # per-thread tmp name: resolver and drainer may write concurrently
            tmp = f"{path}.{threading.get_ident()}.tmp"
            with open(tmp, "w") as f:
                json.dump(self.status(), f, indent=1, sort_keys=True)
            os.replace(tmp, path)       # atomic: status readers never see a torn file
        except OSError as e:
            logger.warning(f"serving: status write failed: {e}")


class _RequestDeadline(Exception):
    """Internal: the request's own deadline (or the drain cap) expired —
    distinct from WatchdogTimeout so a deadline-bound request is not
    mistaken for a hung engine (no breaker failure, no timeout counter)."""


def from_ds_config(engine, ds_config, agent=None, start: bool = True,
                   status_dir: Optional[str] = None) -> Optional[ServingFrontEnd]:
    """Build a front-end from a parsed ``DeepSpeedConfig``. Returns None
    when the ``serving`` block is absent or disabled — note the STRICT
    no-op contract lives one level up: code that has no serving block
    must never import this package at all."""
    if not getattr(ds_config, "serving_present", False) \
            or not ds_config.serving.enabled:
        return None
    if ds_config.telemetry.enabled and _telemetry.get_session() is None:
        _telemetry.configure(ds_config.telemetry)
    return ServingFrontEnd(engine, ds_config.serving, agent=agent,
                           start=start, status_dir=status_dir)
