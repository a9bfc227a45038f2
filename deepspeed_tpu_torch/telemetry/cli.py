"""``python -m deepspeed_tpu_torch.telemetry.cli``: a run's metrics as a table.

Counterpart of ``bin/ds_metrics``, and it calls itself ``ds_metrics``. The
telemetry session appends one JSON object per series per flush to
``<output_dir>/metrics.jsonl``; this renders the run's final state:
counters and gauges at their last value, histograms at their last
count/p50/p90/p99/max. Under the table come the status lines of the
``rewind/*``, ``elasticity/*``, ``blackbox/*`` (and the other) series, drawn
by the functions ``goodput.top`` draws them with
(``goodput/tail.py``), so the two views agree. Standard library only.

Usage: python -m deepspeed_tpu_torch.telemetry.cli <metrics.jsonl | telemetry_dir>
       [--json] [--memory] [--serving] [--follow [--interval S]]

  --json      the summary as JSON instead of a table
  --memory    the memory profiler's ``profiling/*`` and ``device/*`` series
  --serving   the front-end's ``serving/*`` series: the request ledger,
              queue and health, TTFT and request percentiles, the breaker
  --follow    re-render on every new flush (rotation and truncation safe);
              composes with --memory and --serving. Ctrl-C exits.
  --interval  the poll interval of --follow in seconds (default 2)
"""

from __future__ import annotations

import json
import os
import sys
from typing import List, Optional

from deepspeed_tpu_torch.goodput import tail as _tail
from deepspeed_tpu_torch.profiling import report as _report

# the series whose status lines go under the table
FOOTER_PREFIXES = ("rewind/", "elasticity/", "sdc/", "gray/", "resilience/sdc_rewinds",
                   "roofline/", "blackbox/", "goodput/mfu")


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float) and (abs(v) >= 1e5 or (v != 0 and abs(v) < 1e-3)):
        return f"{v:.4g}"
    if isinstance(v, float):
        return f"{v:.4f}".rstrip("0").rstrip(".") or "0"
    return str(v)


def render_table(records: List[dict]) -> str:
    header = ("kind", "name", "labels", "value/count", "p50", "p90", "p99", "max")
    rows = [header]
    for rec in records:
        labels = ",".join(f"{k}={v}" for k, v in sorted((rec.get("labels") or {}).items()))
        if rec["kind"] == "histogram":
            rows.append(("histogram", rec["name"], labels, _fmt(rec.get("count")),
                         _fmt(rec.get("p50")), _fmt(rec.get("p90")), _fmt(rec.get("p99")),
                         _fmt(rec.get("max"))))
        else:
            rows.append((rec["kind"], rec["name"], labels, _fmt(rec.get("value")),
                         "-", "-", "-", "-"))
    widths = [max(len(r[i]) for r in rows) for i in range(len(header))]
    lines = []
    for i, r in enumerate(rows):
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def status_footer(records: List[dict]) -> Optional[str]:
    """The rewind, resize, SDC, gray, roofline and incident lines of the
    series present. A counter's record holds its cumulative value, so the
    last one wins."""
    gauges, counters, step = {}, {}, None
    for rec in records:
        name = str(rec.get("name", ""))
        if rec.get("step") is not None:
            step = max(step or 0, rec["step"])
        if not name.startswith(FOOTER_PREFIXES):
            continue
        if rec.get("kind") == "counter":
            counters[_tail.labeled_key(name, rec.get("labels") or {})] = rec.get("value") or 0
        else:
            gauges[name] = rec.get("value")
    if not gauges and not counters:
        return None
    lines = [_tail.render_rewind_line(gauges, counters, step=step),
             _tail.render_resize_line(gauges, counters),
             _tail.render_sdc_line(gauges, counters),
             _tail.render_gray_line(gauges, counters),
             _tail.render_roofline_line(gauges, counters),
             _tail.render_incident_line(gauges, counters)]
    lines = [ln for ln in lines if ln]
    return "\n".join(lines) if lines else None


def render_records(records: List[dict], path: str, as_json: bool = False,
                   memory: bool = False, serving: bool = False) -> str:
    """One rendering of a record list: the one-shot and --follow body."""
    if serving:
        srv = [r for r in records if str(r.get("name", "")).startswith("serving/")]
        return json.dumps(srv, indent=2) if as_json else \
            _report.render_serving_summary(srv, source=path)
    if memory:
        mem = [r for r in records
               if str(r.get("name", "")).startswith(("profiling/", "device/"))]
        return json.dumps(mem, indent=2) if as_json else \
            _report.render_memory_summary(mem, source=path)
    if as_json:
        return json.dumps(records, indent=2)
    if not records:
        return f"ds_metrics: {path} holds no metric records"
    steps = [r.get("step") for r in records if r.get("step") is not None]
    head = f"telemetry summary: {path}" + (f" (through step {max(steps)})" if steps else "")
    body = head + "\n" + render_table(records)
    footer = status_footer(records)
    return body + "\n" + footer if footer else body


def follow(path: str, as_json: bool = False, memory: bool = False, serving: bool = False,
           interval: float = 2.0, max_polls: Optional[int] = None, out=None) -> int:
    """Re-render on every new flush (``goodput/tail.py`` ``follow_loop``);
    ``max_polls`` bounds the loop. Malformed-line counts go to stderr."""
    def note_bad_lines(follower, _out):
        if follower.tailer.bad_lines:
            print(f"ds_metrics: skipped {follower.tailer.bad_lines} malformed line(s)",
                  file=sys.stderr)

    return _tail.follow_loop(path, lambda recs: render_records(recs, path, as_json, memory,
                                                               serving),
                             interval=interval, max_polls=max_polls, out=out,
                             on_render=note_bad_lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = {f: f in argv for f in ("--json", "--memory", "--serving", "--follow")}
    interval = 2.0
    if "--interval" in argv:
        i = argv.index("--interval")
        if i + 1 >= len(argv):
            print("ds_metrics: --interval requires a value", file=sys.stderr)
            return 2
        try:
            interval = float(argv[i + 1])
        except ValueError:
            print(f"ds_metrics: --interval needs a number, got {argv[i + 1]!r}",
                  file=sys.stderr)
            return 2
        del argv[i:i + 2]
    argv = [a for a in argv if a not in flags]
    if len(argv) != 1 or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv and argv[0] in ("-h", "--help") else 2
    path = argv[0]
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.jsonl")
    as_json, memory, serving = flags["--json"], flags["--memory"], flags["--serving"]
    if flags["--follow"]:
        # the file may not exist yet: the tailer polls for it
        try:
            return follow(path, as_json=as_json, memory=memory, serving=serving,
                          interval=max(0.1, interval))
        except KeyboardInterrupt:
            return 0
    if not os.path.isfile(path):
        print(f"ds_metrics: no such file: {path}", file=sys.stderr)
        return 1
    records, bad = _report.load_metrics_records(path)
    print(render_records(records, path, as_json, memory, serving))
    if bad:
        print(f"ds_metrics: skipped {bad} malformed line(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
