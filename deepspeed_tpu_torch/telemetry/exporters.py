"""Exporters: registry snapshots → JSONL event log / Prometheus text.

Counterpart of ``deepspeed_tpu/telemetry/exporters.py`` with the same
record schema and text format, so ``bin/ds_metrics`` and ``bin/ds_serve
status`` read a port run's directory as they read a JAX run's. File
exporters are written by process 0 only (the session gates them). The
Prometheus file is rewritten atomically each flush (textfile-collector
convention); the JSONL log is append-only, one JSON object per metric per
flush. The JAX package's ``MonitorExporter`` (the TensorBoard / W&B / CSV
fan-out) needs ``monitor/``, a later slice: ``telemetry.monitor: true``
raises at config time.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import List, Optional


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
