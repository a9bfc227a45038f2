"""Exporters: registry snapshots → JSONL event log / Prometheus text /
monitor fan-out.

Counterpart of ``deepspeed_tpu/telemetry/exporters.py`` with the same
record schema, text format and monitor tags, so ``bin/ds_metrics`` and
``bin/ds_serve status`` read a port run's directory as they read a JAX
run's. File exporters are written by process 0 only (the session gates
them). The Prometheus file is rewritten atomically each flush
(textfile-collector convention); the JSONL log is append-only, one JSON
object per metric per flush; :class:`MonitorExporter` hands the series to
the engine's ``MonitorMaster`` (TensorBoard / W&B / CSV), which writes on
process 0 only.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import List, Optional

from deepspeed_tpu_torch.utils.logging import logger


_PROM_NAME = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    n = _PROM_NAME.sub("_", name)
    return n if not n[:1].isdigit() else "_" + n


def _prom_labels(labels: dict, extra: Optional[dict] = None) -> str:
    items = {**(labels or {}), **(extra or {})}
    if not items:
        return ""
    body = ",".join(f'{_prom_name(str(k))}="{str(v)}"' for k, v in sorted(items.items()))
    return "{" + body + "}"


class JSONLExporter:
    """Append-only event log: one line per metric per flush, each stamped
    with wall-clock ``ts`` and the training ``step`` of the flush."""

    def __init__(self, path: str):
        self.path = path

    def export(self, snapshot: List[dict], step: Optional[int] = None) -> None:
        ts = time.time()
        with open(self.path, "a") as f:
            for rec in snapshot:
                line = {"ts": ts, "step": step, **rec}
                f.write(json.dumps(line) + "\n")


class PrometheusExporter:
    """Text exposition format, rewritten whole each flush (tmp + replace so
    a scraper never reads a torn file). Histograms with configured bounds
    render as native prometheus histograms (cumulative ``_bucket{le=}``);
    unbounded ones render as summaries with p50/p90/p99 quantiles."""

    def __init__(self, path: str, prefix: str = "ds_"):
        self.path = path
        self.prefix = prefix

    def render(self, snapshot: List[dict]) -> str:
        lines = []
        typed = set()
        for rec in snapshot:
            name = self.prefix + _prom_name(rec["name"])
            kind = rec["kind"]
            labels = rec.get("labels") or {}
            if kind in ("counter", "gauge"):
                if name not in typed:
                    typed.add(name)
                    lines.append(f"# TYPE {name} {kind}")
                lines.append(f"{name}{_prom_labels(labels)} {rec['value']:.10g}")
            elif kind == "histogram":
                is_hist = rec.get("bounds") is not None
                if name not in typed:
                    typed.add(name)
                    lines.append(f"# TYPE {name} {'histogram' if is_hist else 'summary'}")
                if is_hist:
                    cum = 0
                    for b, c in zip(rec["bounds"], rec["bucket_counts"]):
                        cum += c
                        lines.append(f"{name}_bucket{_prom_labels(labels, {'le': f'{b:.10g}'})} {cum}")
                    lines.append(f"{name}_bucket{_prom_labels(labels, {'le': '+Inf'})} {rec['count']}")
                else:
                    for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
                        lines.append(f"{name}{_prom_labels(labels, {'quantile': q})} {rec[key]:.10g}")
                lines.append(f"{name}_sum{_prom_labels(labels)} {rec['sum']:.10g}")
                lines.append(f"{name}_count{_prom_labels(labels)} {rec['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def export(self, snapshot: List[dict], step: Optional[int] = None) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.render(snapshot))
        os.replace(tmp, self.path)


class MonitorExporter:
    """The registry through a ``MonitorMaster`` (``monitor/monitor.py``):
    counters and gauges export their value, histograms their p50 under
    ``<tag>/p50``. Tags are ``Telemetry/<name>[/<k>=<v>...]`` (labels sorted),
    apart from the engine's own ``Train/Samples/*`` events."""

    def __init__(self, monitor):
        self.monitor = monitor

    def export(self, snapshot: List[dict], step: Optional[int] = None) -> None:
        if not getattr(self.monitor, "enabled", False):
            return
        s = int(step or 0)
        events = []
        for rec in snapshot:
            tag = "Telemetry/" + rec["name"]
            if rec.get("labels"):
                tag += "/" + "/".join(f"{k}={v}" for k, v in sorted(rec["labels"].items()))
            if rec["kind"] in ("counter", "gauge"):
                events.append((tag, float(rec["value"]), s))
            else:
                events.append((tag + "/p50", float(rec["p50"]), s))
        if events:
            try:
                self.monitor.write_events(events)
            except Exception as e:  # noqa: BLE001 - a wedged writer must not stop training
                logger.warning(f"telemetry monitor fan-out failed: {e}")
