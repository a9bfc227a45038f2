"""Unified telemetry: metrics registry + step tracing + exporters.

Counterpart of ``deepspeed_tpu/telemetry/``. One process-wide *session*
owns:

* a :class:`~deepspeed_tpu_torch.telemetry.registry.MetricsRegistry`
  (counters, gauges, histograms with p50/p90/p99 reservoirs) that the
  training engine, the inference engine, the serving front-end and the
  resilience modules feed;
* a :class:`~deepspeed_tpu_torch.telemetry.tracing.StepTracer` emitting
  Chrome-trace/Perfetto JSON spans for the host-visible phases;
* exporters: append-only JSONL (``bin/ds_metrics`` renders it) and the
  Prometheus text exposition, written by process 0 only (the
  ``torch.distributed`` rank), and with ``monitor`` the engine's
  ``MonitorMaster`` fan-out (TensorBoard / W&B / CSV get the series as
  ``Telemetry/*`` tags).

Enabled by the ``telemetry`` ds_config block (the training engine's init
and the serving front-end's ``from_ds_config`` call :func:`configure`);
when off, :func:`get_registry` / :func:`get_tracer` return shared no-op
singletons, so every instrumentation point costs one call into a ``pass``.
Instrumented code never holds the registry across a reconfigure: it
re-fetches through the module functions.
"""

from __future__ import annotations

import atexit
import os
from typing import Optional

from deepspeed_tpu_torch.telemetry.exporters import (JSONLExporter, MonitorExporter,
                                                     PrometheusExporter)
from deepspeed_tpu_torch.telemetry.registry import (NOOP_REGISTRY, Counter, Gauge, Histogram,
                                                    MetricsRegistry, NoopRegistry)
from deepspeed_tpu_torch.telemetry.tracing import NOOP_TRACER, NoopTracer, StepTracer
from deepspeed_tpu_torch.utils.logging import logger

__all__ = [
    "MetricsRegistry", "NoopRegistry", "Counter", "Gauge", "Histogram",
    "StepTracer", "NoopTracer", "TelemetrySession", "JSONLExporter",
    "PrometheusExporter", "MonitorExporter", "configure", "install_session",
    "deconfigure", "get_session", "get_registry", "get_tracer", "flush",
    "METRICS_FILE", "PROMETHEUS_FILE", "TRACE_FILE",
]

METRICS_FILE = "metrics.jsonl"
PROMETHEUS_FILE = "metrics.prom"
TRACE_FILE = "trace.json"


def _process_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class TelemetrySession:
    """One run's live telemetry state: registry + tracer + exporters.

    File exporters exist only on process 0; the session still collects on
    every rank. Traces are per rank (``trace.json`` on rank 0,
    ``trace.rank<N>.json`` beside it on the others). With ``cfg.monitor``
    and a ``monitor`` (the engine's ``MonitorMaster``, which gates itself
    to process 0) the series also go to its writers."""

    def __init__(self, cfg, monitor=None):
        self.cfg = cfg
        self.source = "manual"          # "config" when installed by configure()
        self.registry = MetricsRegistry(
            default_max_samples=cfg.histogram_max_samples,
            default_bounds=cfg.histogram_buckets or None)
        rank = _process_rank()
        self.tracer = (StepTracer(max_events=cfg.max_trace_events, pid=rank)
                       if cfg.trace else NOOP_TRACER)
        # a new session is a new trace file and clock: the comm layer's
        # per-(op, group) collective seq counters restart with it, so every
        # rank's (op, seq, group) identities stay matchable across restarts
        from deepspeed_tpu_torch.comm import comm as _comm

        _comm.reset_collective_trace_seq()
        self.output_dir = cfg.output_dir
        self.exporters = []
        self.trace_path = None
        if rank == 0:
            os.makedirs(cfg.output_dir, exist_ok=True)
            if cfg.jsonl:
                self.exporters.append(JSONLExporter(os.path.join(cfg.output_dir, METRICS_FILE)))
            if cfg.prometheus:
                self.exporters.append(
                    PrometheusExporter(os.path.join(cfg.output_dir, PROMETHEUS_FILE)))
        if cfg.trace:
            name = TRACE_FILE if rank == 0 else TRACE_FILE.replace(".json", f".rank{rank}.json")
            os.makedirs(cfg.output_dir, exist_ok=True)
            self.trace_path = os.path.join(cfg.output_dir, name)
            _rotate_stale_trace(self.trace_path)
        if cfg.monitor and monitor is not None:
            self.exporters.append(MonitorExporter(monitor))
        self._last_step = 0

    def step_end(self, step: int) -> None:
        """The training engine calls this once per global step; flushes
        every ``flush_interval`` steps."""
        self._last_step = step
        if self.cfg.flush_interval and step % self.cfg.flush_interval == 0:
            self.flush(step)

    def flush(self, step: Optional[int] = None) -> None:
        snap = self.registry.snapshot()
        step = self._last_step if step is None else step
        for e in self.exporters:
            try:
                e.export(snap, step=step)
            except OSError as exc:      # a full or gone disk must not kill the run
                logger.warning(f"telemetry exporter {type(e).__name__} failed: {exc}")
        if self.trace_path is not None:
            try:
                self.tracer.write(self.trace_path)
            except OSError as exc:
                logger.warning(f"telemetry trace write failed: {exc}")


def _rotate_stale_trace(path: str) -> None:
    """A new session does not clobber the previous session's trace: the old
    file moves aside as ``trace.session<N>[...].json``."""
    if not os.path.exists(path):
        return
    head, tail = os.path.split(path)
    suffix = tail[len("trace"):]                # ".json" / ".rank3.json"
    for n in range(1, 10_000):
        rotated = os.path.join(head, f"trace.session{n}{suffix}")
        if not os.path.exists(rotated):
            break
    try:
        os.replace(path, rotated)
    except OSError as exc:
        logger.warning(f"telemetry: could not rotate stale trace {path}: {exc}")


_session: Optional[TelemetrySession] = None
_atexit_registered = False


def configure(cfg=None, monitor=None) -> Optional[TelemetrySession]:
    """Install (or tear down) the process-wide session from a ds_config
    ``telemetry`` block, fanning out through ``monitor`` when the block's
    ``monitor`` is on. A disabled block removes only a previous
    config-installed session: a new engine does not inherit the last
    engine's session, and a test's manual install stays."""
    global _session, _atexit_registered
    if cfg is None or not cfg.enabled:
        if _session is not None and _session.source == "config":
            _flush_quietly(_session)
            _session = None
        return None
    if _session is not None:
        _flush_quietly(_session)          # the old session's data lands first
    s = TelemetrySession(cfg, monitor=monitor)
    s.source = "config"
    _session = s
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(_atexit_flush)
    return s


def _flush_quietly(s: TelemetrySession) -> None:
    try:
        s.flush()
    except Exception as exc:    # noqa: BLE001 - a teardown flush never raises
        logger.warning(f"telemetry flush failed: {exc}")


def _atexit_flush():
    if _session is not None:
        _flush_quietly(_session)


def install_session(s: TelemetrySession) -> None:
    """Test / embedding hook: install a hand-built session."""
    global _session
    _session = s


def deconfigure() -> None:
    """Flush and remove the session, whoever installed it."""
    global _session
    if _session is not None:
        _flush_quietly(_session)
    _session = None


def get_session() -> Optional[TelemetrySession]:
    return _session


def get_registry():
    """The live registry, or the shared no-op when telemetry is off."""
    return _session.registry if _session is not None else NOOP_REGISTRY


def get_tracer():
    return _session.tracer if _session is not None else NOOP_TRACER


def flush() -> None:
    if _session is not None:
        _session.flush()
