"""Span-based step tracing → Chrome-trace / Perfetto JSON.

Counterpart of ``deepspeed_tpu/telemetry/tracing.py``. Spans mark
host-visible phases (data / fwd / bwd / step / train_batch, checkpoint
save and load, inference prefill and decode, the serving front-end's
admission wait and ticks); the writer emits the Chrome Trace Event Format
(``{"traceEvents": [...]}``, complete events ``ph="X"`` with microsecond
``ts``/``dur``) that ``chrome://tracing`` and https://ui.perfetto.dev open.
Device-side kernel timing is ``torch.profiler``'s job; these spans are the
host skeleton that says which phase of which step to look at.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import List

from deepspeed_tpu_torch.utils.logging import logger


class StepTracer:
    """Collects complete-span events; bounded by ``max_events`` (overflow is
    counted — surfaced in the trace metadata and a one-shot warning — and
    never grows memory without bound on a long run)."""

    def __init__(self, max_events: int = 100_000, pid: int = 0):
        # monotonic+epoch clock anchor, captured back-to-back: span ``ts``
        # values are µs since _t0, and epoch0 places that zero on wall
        # time — how ds_prof goodput stitches sessions across elastic
        # restarts, and how merged Perfetto timelines get absolute time
        self._t0 = time.perf_counter()
        self.epoch0 = time.time()
        self.pid = int(pid)
        self.max_events = int(max_events)
        self.events: List[dict] = []
        self.dropped = 0
        self._written_state = None      # (len(events), dropped) at last write

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _emit(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            if self.dropped == 0:
                # once, loudly: a silently truncated trace reads as "the
                # run got quiet at step N" — the worst kind of wrong
                logger.warning(
                    f"StepTracer hit max_events={self.max_events}; further "
                    "spans are counted but not recorded (dropped-event count "
                    "lands in the trace metadata; raise "
                    "telemetry.max_trace_events to keep them)")
            self.dropped += 1
            return
        self.events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "train", **args):
        """``with tracer.span("fwd", step=3): ...`` — records one complete
        event covering the block (exceptions still close the span)."""
        ts = self._now_us()
        try:
            yield self
        finally:
            self._emit({"name": name, "cat": cat, "ph": "X", "ts": ts,
                        "dur": self._now_us() - ts, "pid": self.pid, "tid": 0,
                        "args": args})

    def instant(self, name: str, cat: str = "train", **args) -> None:
        self._emit({"name": name, "cat": cat, "ph": "i", "s": "p",
                    "ts": self._now_us(), "pid": self.pid, "tid": 0,
                    "args": args})

    def complete(self, name: str, dur_us: float, cat: str = "train",
                 **args) -> None:
        """Record a complete span ending NOW with the given duration —
        for callers that already measured the interval themselves (the
        comm layer's ``timed_op`` wraps the block+sync it times)."""
        end = self._now_us()
        self._emit({"name": name, "cat": cat, "ph": "X",
                    "ts": end - float(dur_us), "dur": float(dur_us),
                    "pid": self.pid, "tid": 0, "args": args})

    def to_chrome_trace(self) -> dict:
        meta = [{"name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
                 "args": {"name": f"deepspeed_tpu_torch rank {self.pid}"}}]
        return {"traceEvents": meta + self.events, "displayTimeUnit": "ms",
                "metadata": {"rank": self.pid, "max_events": self.max_events,
                             "dropped_events": self.dropped,
                             "clock_anchor": {"epoch_s": self.epoch0,
                                              "monotonic_s": self._t0}}}

    def write(self, path: str) -> None:
        """Atomic dump (tmp + replace): a reader mid-run never sees a
        half-written JSON. No-op when nothing changed since the last write —
        the whole-file dump is O(spans so far) and a flush with no new data
        should cost nothing. The FIRST drop counts as a change (so the
        metadata's truncation flag reaches disk), but later drop-count
        bumps do not: past the cap only `dropped` moves, and re-serializing
        the full capped buffer every flush just to update one integer is
        the exact cost this guard exists to avoid — the on-disk count is
        'dropped as of the first post-cap flush', the in-memory counter
        stays exact."""
        state = (len(self.events), self.dropped > 0)
        if state == self._written_state:
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        os.replace(tmp, path)
        self._written_state = state


class _NullCtx:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


class NoopTracer:
    """Zero-overhead stand-in when tracing is off."""

    events: List[dict] = []
    dropped = 0

    def span(self, name: str, cat: str = "train", **args):
        return _NULL

    def instant(self, name: str, cat: str = "train", **args) -> None:
        pass

    def complete(self, name: str, dur_us: float, cat: str = "train",
                 **args) -> None:
        pass

    def to_chrome_trace(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        pass


NOOP_TRACER = NoopTracer()
