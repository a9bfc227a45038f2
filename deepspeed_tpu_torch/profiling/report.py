"""Render a run's telemetry for people: the memory and serving summaries.

Counterpart of ``deepspeed_tpu/profiling/report.py``'s
:func:`load_metrics_records` (the last record per series of a
``metrics.jsonl``), :func:`format_bytes`, :func:`format_us`, the fleet
views of ``profiling/aggregate.py``'s analyses
(:func:`render_straggler_report`, :func:`render_exposed_comm`,
:func:`render_critical_path`), :func:`render_memory_summary` (the
``profiling/*`` series) and :func:`render_serving_summary` (the
``serving/*`` series). Standard library only, so the views run on a box
with no accelerator; the same records render to the same text as
``bin/ds_metrics --memory``, ``bin/ds_prof merge`` and ``bin/ds_serve
status`` print.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple


def load_metrics_records(path: str) -> Tuple[List[dict], int]:
    """Last record per (kind, name, labels) from a telemetry metrics.jsonl,
    plus the count of malformed lines (a run killed mid-append leaves a
    torn last line — counted, not fatal). The one loader both
    ``bin/ds_metrics`` and ``ds_prof memory`` share."""
    last = {}
    order = []
    bad = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                key = (rec["kind"], rec["name"],
                       tuple(sorted((rec.get("labels") or {}).items())))
            except (ValueError, KeyError, TypeError):
                bad += 1
                continue
            if key not in last:
                order.append(key)
            last[key] = rec
    return [last[k] for k in order], bad


def format_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.0f} {unit}" if unit == "B" else f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} TiB"


def format_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.2f} s"
    if us >= 1e3:
        return f"{us / 1e3:.2f} ms"
    return f"{us:.0f} us"


def _table(rows: Sequence[Sequence[str]]) -> str:
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = []
    for i, r in enumerate(rows):
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


# ----------------------------------------------------------------- fleet views
def render_straggler_report(rows, rank_cost: Dict[int, float],
                            top_k: int = 10) -> str:
    """The top-K straggler table (which rank, which collective, how many µs
    the rest of the fleet waited for it) and the totals by rank."""
    if not rows:
        return ("straggler analysis: no cross-rank collective matches found "
                "(need comm span events with (op, seq, group) args on >= 2 ranks)")
    out = [f"straggler table (top {min(top_k, len(rows))} collectives by fleet cost):"]
    table = [("straggler", "collective", "group", "arrival skew", "fleet cost")]
    for r in rows[:top_k]:
        table.append((f"rank {r.rank}", f"{r.op}#{r.seq}", r.group or "world",
                      format_us(r.skew_us), format_us(r.fleet_cost_us)))
    out.append(_table(table))
    worst = sorted(rank_cost.items(), key=lambda kv: -kv[1])
    total = sum(rank_cost.values())
    out.append("")
    out.append("fleet waiting time by straggling rank:")
    for rank, cost in worst:
        if cost <= 0:
            continue
        pct = 100.0 * cost / total if total else 0.0
        out.append(f"  rank {rank:<4} {format_us(cost):>12}  ({pct:.0f}%)")
    if total == 0:
        out.append("  (no measurable skew)")
    return "\n".join(out)


def render_exposed_comm(summary: Optional[dict]) -> str:
    """The exposed-communication line: comm time no compute covers,
    averaged per step."""
    if not summary or not summary.get("per_step"):
        return ("exposed_comm_us_per_step: n/a (no comm spans matched to a "
                "step window)")
    per_step = summary["per_step"]
    avg = summary["avg_us_per_step"]
    worst_step = max(per_step, key=per_step.get)
    return (f"exposed_comm_us_per_step: {avg:.0f} "
            f"(avg over {len(per_step)} step(s); worst step {worst_step}: "
            f"{format_us(per_step[worst_step])})")


def render_critical_path(cp) -> str:
    """One step's longest dependency chain, segment by segment."""
    if cp is None:
        return "critical path: no step spans found"
    out = [f"critical path (step {cp.step}): {format_us(cp.total_us)} on-path "
           f"of {format_us(cp.wall_us)} wall "
           f"({100.0 * cp.total_us / cp.wall_us if cp.wall_us else 0.0:.0f}% serialized)"]
    for rank, name, ts, dur in cp.segments:
        out.append(f"  rank {rank:<4} {name:<24} {format_us(dur):>12}  @ {format_us(ts)}")
    return "\n".join(out)


# ------------------------------------------------------------- memory summary
def render_memory_summary(records: List[dict],
                          source: Optional[str] = None) -> str:
    """The ``profiling/*`` series of a record list (the last snapshot per
    series): live bytes by bucket, peak deltas by span, the executable
    accounting where a run recorded one, the device gauges, leak suspects."""
    buckets, spans, execu, leaks, device = [], [], [], [], []
    total = frac = None
    for rec in records:
        name = rec.get("name", "")
        labels = rec.get("labels") or {}
        if name.startswith("device/"):
            device.append((name[len("device/"):], rec.get("value", 0)))
        elif name == "profiling/live_bytes":
            buckets.append((labels.get("bucket", "?"), rec.get("value", 0)))
        elif name == "profiling/live_bytes_total":
            total = rec.get("value", 0)
        elif name == "profiling/attributed_fraction":
            frac = rec.get("value")
        elif name == "profiling/span_peak_bytes":
            spans.append((labels.get("span", "?"), rec.get("max", 0),
                          rec.get("p50", 0), rec.get("count", 0)))
        elif name.startswith("profiling/executable_"):
            execu.append((name[len("profiling/executable_"):-len("_bytes")],
                          rec.get("value", 0)))
        elif name == "profiling/leak_suspects":
            leaks.append((labels.get("bucket", "?"), rec.get("value", 0)))
    if not (buckets or spans or execu or leaks or device or total is not None):
        return ("no profiling/* series found"
                + (f" in {source}" if source else "")
                + " — enable the ds_config `profiling` block (and `telemetry`)")
    out = ["memory profile" + (f": {source}" if source else "")]
    if buckets:
        out.append("")
        out.append("live device bytes by bucket:")
        for bucket, n in sorted(buckets, key=lambda kv: -kv[1]):
            out.append(f"  {bucket:<18} {format_bytes(n):>12}")
        if total is not None:
            line = f"  {'total live':<18} {format_bytes(total):>12}"
            if frac is not None:
                line += f"  ({100.0 * frac:.1f}% attributed)"
            out.append(line)
    if execu:
        # recorded by the JAX package only: CUDA has no compiled program to
        # read (profiling/memory.py executable_memory)
        out.append("")
        out.append("train-step executable (XLA memory_analysis):")
        for key, n in execu:
            out.append(f"  {key:<18} {format_bytes(n):>12}")
    if spans:
        out.append("")
        out.append("peak HBM delta by span (max over run):")
        for span, mx, p50, count in sorted(spans, key=lambda s: -s[1]):
            out.append(f"  {span:<18} {format_bytes(mx):>12}  "
                       f"(p50 {format_bytes(p50)}, {int(count)} samples)")
    if device:
        out.append("")
        out.append("device memory (runtime stats, device 0):")
        for key, n in device:
            out.append(f"  {key:<18} {format_bytes(n):>12}")
    out.append("")
    if leaks:
        out.append("leak suspects (monotonic live-bytes growth):")
        for bucket, n in sorted(leaks, key=lambda kv: -kv[1]):
            out.append(f"  {bucket:<18} flagged {int(n)}x")
    else:
        out.append("leak suspects: none")
    return "\n".join(out)


# ------------------------------------------------------------ serving summary
# mirror of serving/frontend.py ServerState.CODES: this module is pure
# stdlib and does not import the serving package (torch) to render a log
SERVING_STATE_NAMES = {0: "starting", 1: "ready", 2: "degraded",
                       3: "draining", 4: "dead"}


def render_serving_summary(records: List[dict],
                           source: Optional[str] = None,
                           status: Optional[dict] = None) -> str:
    """The operator SLO view of a serving run, from the ``serving/*``
    registry series (last snapshot per series) plus the optional
    ``serving_status.json`` payload ``ds_serve status`` passes in:
    health state + queue, the request-lifecycle ledger (admitted must
    equal the sum of terminal outcomes — the no-silent-drops invariant,
    visible from the JSONL alone), latency percentiles vs deadline, and
    the circuit-breaker transition history."""
    counters, hists, gauges = {}, {}, {}
    for rec in records:
        name = rec.get("name", "")
        if not name.startswith("serving/"):
            continue
        short = name[len("serving/"):]
        labels = rec.get("labels") or {}
        key = short if not labels else \
            short + "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"
        if rec.get("kind") == "histogram":
            hists[short] = rec
        elif rec.get("kind") == "gauge":
            gauges[short] = rec.get("value")
        else:
            counters[key] = rec.get("value", 0)
    if not (counters or hists or gauges) and status is None:
        return ("no serving/* series found"
                + (f" in {source}" if source else "")
                + " — enable the ds_config `serving` + `telemetry` blocks")
    out = ["serving summary" + (f": {source}" if source else "")]

    state = None
    if status is not None:
        state = status.get("state")
    elif "state" in gauges:
        state = SERVING_STATE_NAMES.get(int(gauges["state"]), "?")
    line = f"state: {state or '?'}"
    if "capacity" in gauges:
        line += f"  capacity: {int(gauges['capacity'])}"
    if "queue_depth" in gauges:
        line += f"  queue_depth: {int(gauges['queue_depth'])}"
    if status is not None and status.get("breaker"):
        line += f"  breaker: {status['breaker']}"
    out.append(line)

    lifecycle = [(k, v) for k, v in sorted(counters.items())
                 if not k.startswith(("circuit_transitions",
                                      "state_transitions",
                                      "tokens_streamed"))]
    if lifecycle:
        out.append("")
        out.append("request lifecycle:")
        table = [("outcome", "count")]
        for k, v in lifecycle:
            table.append((k, f"{int(v)}"))
        out.append("\n".join("  " + ln for ln in _table(table).splitlines()))
        admitted = counters.get("admitted", 0)
        if admitted:
            terminal = sum(v for k, v in counters.items()
                           if k in ("completed", "timed_out", "drained",
                                    "failed")
                           or k.startswith("shed_admitted{"))
            live = int(gauges.get("queue_depth", 0))   # queued + in flight
            tick = ("OK" if int(terminal) + live == int(admitted)
                    else "MISMATCH — an admitted request is unaccounted for")
            out.append(f"  (no-silent-drops ledger: admitted {int(admitted)} "
                       f"== completed+timed_out+drained+failed+shed_admitted "
                       f"[{int(terminal)}] + still-live [{live}] … {tick}; "
                       "at-the-door shed{…} refusals sit outside the "
                       "admitted ledger)")
        if "tokens_streamed" in counters:
            out.append(f"  tokens streamed: {int(counters['tokens_streamed'])}")

    if hists:
        out.append("")
        out.append("latency (s unless noted):")
        table = [("series", "count", "p50", "p90", "p99", "max")]
        for short in ("ttft_seconds", "request_seconds", "queue_wait_seconds",
                      "prefill_seconds", "decode_chunk_seconds",
                      "ttft_deadline_fraction", "tokens_per_request"):
            rec = hists.get(short)
            if rec is None:
                continue
            fmt = lambda v: "-" if v is None else f"{v:.4g}"
            table.append((short, f"{int(rec.get('count', 0))}",
                          fmt(rec.get("p50")), fmt(rec.get("p90")),
                          fmt(rec.get("p99")), fmt(rec.get("max"))))
        if len(table) > 1:
            out.append("\n".join("  " + ln for ln in _table(table).splitlines()))
        # TTFT decomposition from the request-scoped spans: where does the
        # first token's latency come from — sitting in the queue, or the
        # prefill compute itself? (p50s of independent series, so the sum
        # is an approximation; it still answers "queue or compute")
        ttft = hists.get("ttft_seconds")
        qw = hists.get("queue_wait_seconds")
        pf = hists.get("prefill_seconds")
        if ttft and ttft.get("count") and qw and pf:
            out.append(f"  ttft decomposition (p50): queue-wait "
                       f"{qw.get('p50', 0):.4g}s + prefill "
                       f"{pf.get('p50', 0):.4g}s ~= ttft "
                       f"{ttft.get('p50', 0):.4g}s")

    trans = [(k, v) for k, v in sorted(counters.items())
             if k.startswith("circuit_transitions")]
    if trans:
        out.append("")
        out.append("circuit breaker transitions:")
        for k, v in trans:
            out.append(f"  {k[len('circuit_transitions'):]:<28} {int(v)}x")
    return "\n".join(out)
