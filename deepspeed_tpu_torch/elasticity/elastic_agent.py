"""The elastic agent: preemption, failure recovery and resume.

Counterpart of ``deepspeed_tpu/elasticity/elastic_agent.py`` (the
reference's ``DSElasticAgent``): a supervision loop around the training
engine that an ``engine_factory()`` builds, for one process or a world of
processes that stop together:

* **preemption**: SIGTERM/SIGINT handlers set a flag (:attr:`preempted`,
  which the serving front-end polls to drain); over several processes the
  flag is max-reduced (``comm.allgather_host``) at the same step boundaries
  (``preempt_sync_interval``), so every rank stops at the same step; the
  stop saves the rewind ladder's emergency tag when the ``rewind`` block is
  armed, else an ordinary checkpoint, and returns ``status="preempted"``;
* **periodic and final checkpoints** through the engine;
* **restart on failure** (one process only): a failing step, a
  ``WatchdogTimeout`` of the step watchdog or a ``BadStepError`` is recorded
  in ``restart_reasons`` and ``restart_log``, paced by
  :class:`~deepspeed_tpu_torch.resilience.retry.RestartBackoff`, and the run
  resumes from the freshest tier of the rewind ladder through a new engine
  (the failed one's state may be half updated), up to ``max_restarts``.
  Over several processes a failure re-raises for the launcher to restart
  the whole job. Each restart record is stamped with the recovery's
  ``{tier, snapshot_step, steps_lost, restore_s}`` and appended to
  ``restart_log.jsonl`` in the telemetry session's directory.

``install_signal_handlers`` also registers SIGUSR1: ``kill -USR1 <pid>``
dumps every thread's stack (stderr at once through ``faulthandler``, and
the watchdog's dump file from a sentinel thread) without stopping the run.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
from typing import Any, Callable, Iterable, Optional

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.resilience.manifest import find_restorable_tag, verify_tag
from deepspeed_tpu_torch.resilience.retry import RestartBackoff
from deepspeed_tpu_torch.utils import locks as _locks
from deepspeed_tpu_torch.utils.logging import log_dist, logger


class PreemptionSignal(Exception):
    """Raised inside the step loop when a preemption flag is set."""


class DSElasticAgent:
    def __init__(self,
                 engine_factory: Callable[[], Any],
                 save_dir: str,
                 checkpoint_interval: int = 100,
                 max_restarts: int = 3,
                 install_signal_handlers: bool = True,
                 tag: Optional[str] = None,
                 preempt_sync_interval: Optional[int] = None,
                 restart_backoff: Optional[RestartBackoff] = None):
        self.engine_factory = engine_factory
        self.save_dir = save_dir
        self.checkpoint_interval = int(checkpoint_interval)
        self.max_restarts = int(max_restarts)
        self.tag = tag
        # exponential restart pacing (shared resilience backoff policy): a
        # crash-looping job should slow down, not hot-spin on a flat delay
        self.restart_backoff = restart_backoff or RestartBackoff()
        self.restart_log: list = []     # one record per restart attempt
        # cross-host flag sync cadence: a per-step blocking allgather would
        # sit in the hot loop for an event with a tens-of-seconds grace
        # window; default = every min(checkpoint_interval, 10) steps (all
        # hosts sync at the SAME deterministic steps — the collective must
        # line up)
        self.preempt_sync_interval = int(
            preempt_sync_interval
            if preempt_sync_interval is not None
            else max(1, min(int(checkpoint_interval) or 10, 10)))
        self._preempted = False
        self.restart_count = 0
        self.engine = None
        # the failure record awaiting its recovery stamp (tier/steps_lost
        # land after the NEXT successful bring-up restores)
        self._pending_restart_record = None
        self._dump_event = threading.Event()
        self._dump_thread = None
        if install_signal_handlers:
            self._install_handlers()
            self._install_stack_dump_signal()

    # ------------------------------------------------------------- signals
    def _install_handlers(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, self._on_preempt)
            except ValueError:      # not in main thread
                logger.warning("elastic agent: cannot install signal handlers "
                               "outside the main thread")
                return

    def _install_stack_dump_signal(self):
        """SIGUSR1 → all-thread stack dump: operators inspect a live wedged
        process (``kill -USR1 <pid>``) without killing it.

        Two layers, in chain order: a Python-level handler that only sets an
        Event (async-signal safe) whose sentinel thread appends the dump to
        the watchdog's default dump file and, with the flight recorder
        armed, asks it for a bundle; then ``faulthandler.register``
        (``chain=True`` back to the Python handler), whose C-level dump to
        stderr still fires even when the main thread is wedged inside one C
        call and no Python handler could ever run."""
        import faulthandler

        if not hasattr(signal, "SIGUSR1"):      # pragma: no cover - windows
            return

        @_locks.signal_safe("sets an Event; file I/O deferred to the "
                            "ds-elastic-sigusr1 sentinel thread")
        def _handler(signum, frame):
            self._dump_event.set()

        try:
            signal.signal(signal.SIGUSR1, _handler)
            faulthandler.register(signal.SIGUSR1, all_threads=True, chain=True)
        except (ValueError, OSError, RuntimeError) as e:
            logger.warning(f"elastic agent: cannot register SIGUSR1 stack-dump "
                           f"handler: {e}")
            return
        self._dump_thread = _locks.spawn_thread(
            self._stack_dump_loop, name="ds-elastic-sigusr1", owner="elastic",
            daemon=True, expect_join=False)
        self._dump_thread.start()

    def _stack_dump_loop(self):
        """Sentinel for the SIGUSR1 file dump (daemon; dies with the
        process — the agent has no teardown hook and needs none)."""
        from deepspeed_tpu_torch.resilience.watchdog import dump_all_stacks

        while True:
            self._dump_event.wait()
            self._dump_event.clear()
            # stderr already got faulthandler's dump; this one goes to the
            # default dump file, and the armed recorder writes a bundle (its
            # own chained handler asks too: its debounce makes them one)
            dump_all_stacks(None, reason="SIGUSR1", to_stderr=False)
            bb = sys.modules.get("deepspeed_tpu_torch.blackbox")
            if bb is not None:
                bb.snap("sigusr1")

    def _on_preempt(self, signum, frame):
        logger.warning(f"elastic agent: received signal {signum} — will "
                       "checkpoint and stop at the next step boundary")
        self._preempted = True

    def preempt(self):
        """Programmatic preemption (tests / external watchers)."""
        self._preempted = True

    @property
    def preempted(self) -> bool:
        """This process's preemption flag (not yet max-reduced over the
        ranks). The serving front-end polls this each worker
        iteration to begin a graceful drain the moment SIGTERM lands,
        without waiting for a step boundary."""
        return self._preempted

    def _preempt_sync(self, step: int) -> bool:
        """The notice reaches one process, but the save and a coherent stop
        step need every rank: the flag is max-reduced at every
        ``preempt_sync_interval``-th step boundary, and the ranks act on the
        synced flag only, so they stop together."""
        if comm.get_world_size() == 1:
            return self._preempted
        if step % self.preempt_sync_interval:
            return False
        import numpy as np

        flags = comm.allgather_host(np.int32(1 if self._preempted else 0))
        return bool(np.max(flags))

    # ---------------------------------------------------------- lifecycle
    def _bring_up(self, resume: bool) -> Any:
        """``resume`` is trusted: run() evaluates _has_checkpoint() once per
        bring-up (the load path verifies again anyway — re-hashing every
        sidecar a third time here buys nothing)."""
        self.engine = self.engine_factory()
        if resume:
            path, _ = self.engine.load_checkpoint(self.save_dir, tag=self.tag)
            if path is None:
                # the checkpoint vanished/corrupted between the check and the
                # load: failing loudly (→ the restart loop, → the launcher)
                # beats silently training fresh weights as if resumed
                raise RuntimeError(
                    f"elastic agent: resume expected a restorable checkpoint "
                    f"in {self.save_dir} (tag={self.tag!r}) but nothing loaded")
            log_dist(f"elastic agent: resumed at step {self.engine.global_steps} on "
                     f"{self.engine.dp_world_size} rank(s)", ranks=[0])
        # runs on the NON-resume path too: a failure record whose restart
        # starts fresh (nothing to restore) must still persist, bare
        self._stamp_recovery()
        return self.engine

    def _stamp_recovery(self):
        """Merge the restore ladder's recovery facts ({tier, snapshot_step,
        steps_lost, restore_s} — stamped by the load path on every
        successful restore) into the goodput restart record: the pending
        record from the failure that caused this bring-up, or a fresh
        'resume' record when this process starts straight from a
        checkpoint (the preemption→emergency-save→new-process path).
        Records persist to restart_log.jsonl after the stamp, so they
        carry the tier and steps_lost."""
        rec = getattr(self.engine, "_last_recovery", None) or {}
        restored_step = int(self.engine.global_steps)
        pending = self._pending_restart_record
        self._pending_restart_record = None
        if pending is None and not rec:
            return
        if not rec:
            # fresh (non-resume) bring-up after a failure: nothing was
            # recovered, but the failure record must not be lost
            self._persist_restart_record(pending)
            return
        if pending is None:
            pending = {"restart": self.restart_count,
                       "error": f"resume from {rec.get('tier', '?')} tier",
                       "step": restored_step, "backoff_s": 0.0,
                       "ts": time.time()}
            self.restart_log.append(pending)
        pending.update({
            "tier": rec.get("tier"),
            "snapshot_step": rec.get("snapshot_step", restored_step),
            "restore_s": rec.get("restore_s"),
        })
        steps_lost = rec.get("steps_lost")
        if steps_lost is None and pending.get("step") is not None:
            # the failing step minus where the ladder put us back
            steps_lost = max(0, int(pending["step"]) - restored_step)
        pending["steps_lost"] = steps_lost
        self._persist_restart_record(pending)

    def _ram_tier_available(self) -> bool:
        """Does the process-global tier-0 ring hold a snapshot? Checked
        WITHOUT importing the rewind module (the strict-no-op contract:
        if it was never imported, no snapshot can exist). An agent pinned
        to an explicit ``tag`` never counts the ring: the load path's
        explicit-tag contract refuses to substitute any other source, so
        treating the ring as resumable would wedge the restart loop on
        a load that can only return nothing."""
        if self.tag is not None:
            return False
        mod = sys.modules.get("deepspeed_tpu_torch.resilience.rewind")
        try:
            return bool(mod and mod.ram_snapshots())
        except Exception:
            return False

    def _has_checkpoint(self) -> bool:
        """A checkpoint exists iff a tag this agent WILL load verifies as
        restorable. A merely non-empty save_dir (dangling 'latest', stray
        files, a half-written tag) used to trigger a resume that silently
        loaded nothing — treating the run as fresh-but-pointed-at-garbage.
        With an explicit ``tag`` the load path refuses to substitute another
        checkpoint, so only THAT tag counts here."""
        # an async save may still be committing (manifest lands last)
        from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import \
            wait_for_pending_saves

        wait_for_pending_saves()
        if self.tag is not None:
            ok, _ = verify_tag(
                os.path.join(os.path.abspath(self.save_dir), self.tag))
            return ok
        return find_restorable_tag(self.save_dir) is not None

    def _checkpoint(self):
        self.engine.save_checkpoint(self.save_dir, tag=self.tag)

    def _preemption_checkpoint(self):
        """The stop-boundary save inside the preemption warning window.
        With the rewind ladder armed, the EMERGENCY path runs instead of
        the ordinary checkpoint: a fresh tier-0 snapshot flushed through
        the verified manifest path as an ``emergency_step<N>`` tag — one
        npz write, sized for a preemption notice's tens-of-seconds
        budget. Falls back to the ordinary verified
        checkpoint when the ladder is absent/disabled or the flush
        fails."""
        rm = getattr(self.engine, "_rewind", None)
        if self.tag is not None:
            # pinned-tag agents resume ONLY from that tag (the load path's
            # explicit-tag contract): an emergency_step<N> tag would never
            # be considered at resume — write the real thing instead
            rm = None
        if rm is not None and rm.emergency_enabled:
            tag = rm.emergency_save(self.save_dir)
            if tag is not None:
                log_dist(f"elastic agent: emergency snapshot {tag!r} "
                         "written; the restore ladder will prefer it over "
                         "a stale 'latest'", ranks=[0])
                return
            logger.warning("elastic agent: emergency save failed; falling "
                           "back to the ordinary checkpoint")
        self._checkpoint()

    # --------------------------------------------------------------- run
    def run(self, batches: Iterable, num_steps: int,
            step_callback: Optional[Callable[[int, float], None]] = None) -> dict:
        """Supervised training: up to ``num_steps`` engine steps with
        periodic checkpoints, preemption-safe exit, and restart-on-failure.

        ``batches``: an iterable yielding one global batch per step (it is
        re-created per restart attempt via iter()). Returns a status dict.
        """
        batches_factory = batches if callable(batches) else (lambda: iter(batches))
        # the RAM tier counts as "something to resume from": an in-process
        # restart after a step failure must not train fresh weights just
        # because no disk checkpoint interval was ever reached
        resume = self._has_checkpoint() or self._ram_tier_available()
        try:
            return self._run_supervised(batches, batches_factory, num_steps,
                                        step_callback, resume)
        finally:
            # the engine's watchdog monitor thread dies with the run on
            # EVERY exit path (complete/preempted/raise) — close() is
            # reversible, a later arm() restarts it
            wd = getattr(self.engine, "_watchdog", None)
            if wd is not None:
                wd.close()

    def _run_supervised(self, batches, batches_factory, num_steps,
                        step_callback, resume) -> dict:
        while True:
            try:
                engine = self._bring_up(resume)
                it = batches_factory() if callable(batches_factory) else iter(batches)
                # the ENGINE's step counter is the authority — a bad-step
                # sentinel rewind inside train_batch moves it backwards, and
                # an agent-side `start + i` counter would silently march past
                # num_steps with fewer steps actually trained
                step = int(engine.global_steps)
                for batch in it:
                    if step >= num_steps:
                        break
                    if self._preempt_sync(step):
                        raise PreemptionSignal()
                    loss = engine.train_batch(batch)
                    if step_callback is not None:
                        step_callback(step, loss)
                    # the engine's step counter (moved back by a sentinel
                    # rewind)
                    done = int(engine.global_steps)
                    advanced = done == step + 1
                    if not advanced:
                        log_dist(f"elastic agent: engine step moved "
                                 f"{step}→{done} (sentinel rewind); "
                                 "re-treading from there", ranks=[0])
                    step = done
                    # never on a rewound iteration: re-saving identical state
                    # over the just-restored tag would drop its manifest and
                    # risk the only good checkpoint on a crash mid-re-save
                    if advanced and self.checkpoint_interval and \
                            done % self.checkpoint_interval == 0:
                        self._checkpoint()
                        # a full healthy checkpoint interval ends the
                        # incident: the next (unrelated) failure should not
                        # pay this one's escalated delay
                        self.restart_backoff.reset()
                self._checkpoint()
                return self._status("complete", engine)
            except PreemptionSignal:
                self._preemption_checkpoint()
                log_dist("elastic agent: preemption checkpoint written; "
                         "exiting cleanly", ranks=[0])
                return self._status("preempted", self.engine)
            except Exception as e:
                from deepspeed_tpu_torch.resilience.watchdog import WatchdogTimeout

                # the dead engine's monitor thread must not outlive it
                wd = getattr(self.engine, "_watchdog", None)
                if wd is not None:
                    wd.close()
                if isinstance(e, WatchdogTimeout):
                    logger.error("elastic agent: hung step detected by the watchdog "
                                 f"({e}); treating as a restartable failure")
                if comm.get_world_size() > 1:
                    # one rank restarting would mismatch the others'
                    # collectives: the launcher restarts the whole job
                    logger.error(f"elastic agent: step failure on a world of "
                                 f"{comm.get_world_size()} ({e}); re-raising for the "
                                 "launcher to restart the whole job")
                    raise
                self.restart_count += 1
                from deepspeed_tpu_torch import telemetry

                telemetry.get_registry().counter("resilience/elastic_restarts").inc()
                if self._pending_restart_record is not None:
                    # the PREVIOUS failure's record never got its recovery
                    # stamp (bring-up itself failed) — persist it bare
                    # rather than silently dropping a restart from the log
                    self._persist_restart_record(self._pending_restart_record)
                    self._pending_restart_record = None
                delay = self.restart_backoff.next_delay()
                from deepspeed_tpu_torch.telemetry.events import stamp_envelope

                # schema_version and event_id on every restart record, so
                # a reader tells record versions apart
                record = stamp_envelope({
                    "restart": self.restart_count,
                    "error": f"{type(e).__name__}: {e}",
                    "step": int(self.engine.global_steps) if self.engine is not None else None,
                    "backoff_s": round(delay, 3),
                    # a wall-clock stamp, to match the record to the gap
                    # between telemetry sessions it explains
                    "ts": time.time(),
                }, kind="restart", severity="error")
                self.restart_log.append(record)
                bb = sys.modules.get("deepspeed_tpu_torch.blackbox")
                if bb is not None:
                    bb.record("restart", "error",
                              {"restart": self.restart_count, "error": record["error"],
                               "backoff_s": record["backoff_s"]},
                              step=record["step"])
                # persistence is DEFERRED to the next successful bring-up
                # (_stamp_recovery), so the on-disk record carries the
                # recovery's {tier, snapshot_step, steps_lost, restore_s};
                # a run that gives up persists the bare record below
                self._pending_restart_record = record
                logger.warning(f"elastic agent: step failure ({e}); "
                               f"restart {self.restart_count}/{self.max_restarts} "
                               f"after {delay:.2f}s backoff")
                if self.restart_count > self.max_restarts:
                    self._persist_restart_record(record)
                    self._pending_restart_record = None
                    raise
                # one verification pass per restart: _bring_up trusts this
                resume = self._has_checkpoint() or self._ram_tier_available()
                self.engine = None
                time.sleep(delay)

    @staticmethod
    def _persist_restart_record(record: dict) -> None:
        """Append the restart record to ``restart_log.jsonl`` beside the
        live telemetry session's metrics. Only reached on the one-process
        restart path (a failure over several ranks re-raises first), so no
        rank gate is needed. Best-effort end to end: accounting
        must never block a restart, so even a wedged telemetry/session
        lookup is swallowed."""
        try:
            import json

            from deepspeed_tpu_torch import telemetry

            session = telemetry.get_session()
            if session is None:
                return
            path = os.path.join(session.output_dir, "restart_log.jsonl")
            with open(path, "a") as f:
                f.write(json.dumps(record) + "\n")
        except Exception as e:
            logger.warning(f"elastic agent: restart_log append failed: {e}")

    def _status(self, status: str, engine) -> dict:
        if status in ("complete", "preempted"):
            # the tier-0 ring's validity window is THIS supervised run:
            # a completed (or emergency-flushed) run must not leave
            # snapshots a LATER run in the same process could mistake
            # for its own resume point (the ring is process-global so
            # in-run restarts can reach it — that need ends here)
            mod = sys.modules.get("deepspeed_tpu_torch.resilience.rewind")
            if mod is not None:
                mod.clear_ram_snapshots()
        return {"status": status,
                "final_step": int(engine.global_steps),
                "restarts": self.restart_count,
                "restart_reasons": [r["error"] for r in self.restart_log],
                "restart_log": list(self.restart_log)}
