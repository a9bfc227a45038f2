"""The job's goodput report: sessions stitched, downtime charged, rendered.

Counterpart of ``deepspeed_tpu/goodput/report.py``. A job that survives
elastic restarts leaves several telemetry sessions behind (each engine's
session moves the previous trace aside as ``trace.session<N>.json``). Each
session's trace carries the monotonic and epoch clock anchor its tracer
took at its start, so sessions of one rank across restarts, or of many
ranks, sit on one wall-time axis: the gap between a session's last span and
the next one's first is downtime, charged to the ``restart`` bucket and
named by the elastic agent's records in ``restart_log.jsonl``
(``elasticity/elastic_agent.py`` appends them beside the metrics when
telemetry is live).

Standard library only: ``python -m deepspeed_tpu_torch.profiling.cli
goodput DIR`` runs on a box with no card.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from deepspeed_tpu_torch.goodput.ledger import (goodput_fraction, load_trace_file,
                                          session_ledger, sum_buckets,
                                          top_badput)
from deepspeed_tpu_torch.goodput.taxonomy import BUCKETS, GOODPUT_BUCKETS

RESTART_LOG_FILE = "restart_log.jsonl"


# ---------------------------------------------------------------- discovery
def find_session_traces(paths: List[str]) -> List[str]:
    """Directories expanded into their session trace files. Unlike
    ``merge``, which leaves out the rotated ``trace.session*`` files (a
    restart's old session would claim its rank twice), the goodput report
    reads every session: the restarts are the point."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if f.startswith("trace") and (f.endswith(".json")
                                              or f.endswith(".jsonl"))))
        else:
            out.append(p)
    return out


def load_restart_log(paths: List[str], explicit: bool = False) -> List[dict]:
    """All restart records from ``restart_log.jsonl`` files in the given
    dirs — or, with ``explicit=True``, from the given file paths
    verbatim (the ``--restart-log`` flag; without it a stray trace
    ``.jsonl`` in the scan list must not be parsed as a restart log).
    Torn lines are skipped."""
    records = []
    for p in paths:
        if os.path.isdir(p):
            path = os.path.join(p, RESTART_LOG_FILE)
        elif explicit or os.path.basename(p) == RESTART_LOG_FILE:
            path = p
        else:
            continue
        if not os.path.isfile(path):
            continue
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return records


# ------------------------------------------------------- straggler (fleet)
def fleet_straggler_intervals(by_rank: Dict[int, List[dict]]
                              ) -> Dict[int, List[Tuple[float, float]]]:
    """Per-rank wait intervals inside matched collectives, in each rank's
    OWN trace timebase: for a matched collective, an early-arriving rank
    spends roughly (last arrival start - its own start) of its span's
    tail waiting for the straggler. An estimate — host spans cannot see
    inside the collective — but a conservative one (capped by the span's
    own duration). Needs >= 2 ranks; returns {} otherwise."""
    if len(by_rank) < 2:
        return {}
    from deepspeed_tpu_torch.profiling.aggregate import FleetTrace

    ft = FleetTrace()
    for rank, events in by_rank.items():
        ft.add_rank(rank, events)
    offsets = ft.clock_offsets()
    out: Dict[int, List[Tuple[float, float]]] = {r: [] for r in by_rank}
    for m in ft.collective_matches(align=True):
        last = max(ts for ts, _ in m.arrivals.values())
        for rank, (ts, dur) in m.arrivals.items():
            wait = min(max(0.0, last - ts), dur)
            if wait <= 0:
                continue
            off = offsets.get(rank, 0.0)
            end_own = ts + dur + off            # back to the rank's own clock
            out[rank].append((end_own - wait, end_own))
    return {r: ivs for r, ivs in out.items() if ivs}


# ------------------------------------------------------------- job stitching
def build_job_report(trace_paths: List[str],
                     restart_log: Optional[List[dict]] = None,
                     straggler: bool = True) -> Dict[str, Any]:
    """The job-level goodput report over one or more session traces.

    Sessions are grouped by rank and ordered on their wall-clock anchors;
    inter-session gaps are charged to ``restart``. Fleet totals sum over
    ranks (fleet-seconds: 2 ranks × 10 s = 20 fleet-seconds). Degrades
    loudly: sessions without anchors cannot be placed on wall time, so
    their inter-session downtime is UNKNOWN (a warning, not a guess).
    """
    warnings: List[str] = []
    sessions = []
    for path in trace_paths:
        try:
            t = load_trace_file(path)
        except (OSError, ValueError) as e:
            warnings.append(f"unreadable trace {path!r}: {e}")
            continue
        if t["bad_lines"]:
            warnings.append(f"{path}: skipped {t['bad_lines']} torn/"
                            "malformed line(s)")
        if not t["events"]:
            warnings.append(f"{path}: empty trace (no events) — ignored")
            continue
        if t["dropped_events"]:
            warnings.append(f"{path}: {t['dropped_events']} span(s) dropped "
                            "at the tracer cap — buckets undercount")
        sessions.append(t)
    if not sessions:
        return {"ranks": [], "sessions": 0, "per_rank": {},
                "buckets_s": {b: 0.0 for b in BUCKETS},
                "fleet_seconds": 0.0, "goodput_fraction": None,
                "restarts": [], "warnings": warnings}

    by_rank: Dict[int, List[dict]] = {}
    for i, t in enumerate(sessions):
        rank = t["rank"] if t["rank"] is not None else -1 - i
        if t["rank"] is None:
            warnings.append(f"{t['path']}: rank unknown — treated as its "
                            "own lane")
        by_rank.setdefault(rank, []).append(t)

    straggler_ivs: Dict[int, List[Tuple[float, float]]] = {}
    if straggler and len(by_rank) >= 2:
        if all(len(ts) == 1 for ts in by_rank.values()):
            # single-session-per-rank fleets only: across restarts the
            # comm seq counters reset, so cross-session matches would be
            # bogus
            straggler_ivs = fleet_straggler_intervals(
                {r: ts[0]["events"] for r, ts in by_rank.items()})
        else:
            multi = sorted(r for r, ts in by_rank.items() if len(ts) > 1)
            warnings.append(
                f"rank(s) {multi} have multiple sessions (elastic "
                "restart): cross-rank straggler attribution SKIPPED — "
                "per-session collective identities cannot be matched "
                "across restarts; straggler_wait reads 0, not measured")

    per_rank: Dict[int, Dict[str, Any]] = {}
    restarts: List[Dict[str, Any]] = []
    all_gaps: List[Dict[str, Any]] = []
    matched_ids: set = set()
    restart_log = list(restart_log or [])
    for rank, ts in by_rank.items():
        anchored = all(t["anchor_epoch_s"] is not None for t in ts)
        if anchored:
            ts.sort(key=lambda t: t["anchor_epoch_s"])
        elif len(ts) > 1:
            warnings.append(
                f"rank {rank}: {len(ts)} sessions but not all carry a "
                "clock anchor — session order follows file order and "
                "restart downtime is UNKNOWN (not charged)")
        ledgers = []
        for t in ts:
            led = session_ledger(t["events"],
                                 straggler_intervals=straggler_ivs.get(rank))
            if led is None:
                warnings.append(f"{t['path']}: no spans — ignored")
                continue
            if t["anchor_epoch_s"] is not None:
                led["start_wall_s"] = t["anchor_epoch_s"] + led["start_us"] / 1e6
                led["end_wall_s"] = t["anchor_epoch_s"] + led["end_us"] / 1e6
            led["path"] = t["path"]
            ledgers.append(led)
        buckets = sum_buckets([l["buckets"] for l in ledgers])
        if anchored:
            for a, b in zip(ledgers, ledgers[1:]):
                gap_s = b["start_wall_s"] - a["end_wall_s"]
                if gap_s < -1.0:
                    warnings.append(
                        f"rank {rank}: sessions {a['path']} and {b['path']} "
                        f"OVERLAP by {-gap_s:.1f}s on wall time — anchors "
                        "inconsistent, downtime not charged")
                    continue
                gap_s = max(0.0, gap_s)
                buckets["restart"] += gap_s * 1e6
                reasons = [r for r in restart_log
                           if isinstance(r.get("ts"), (int, float))
                           and a["end_wall_s"] - 1.0 <= r["ts"]
                           <= b["start_wall_s"] + 1.0]
                matched_ids.update(id(r) for r in reasons)
                entry = {
                    "rank": rank, "gap_s": gap_s,
                    "after": a["path"], "before": b["path"],
                    "reasons": [r.get("error", "?") for r in reasons],
                    # the rewind ladder's recovery facts, when the
                    # agent stamped them: which tier served the
                    # restore and what the failure cost (a resize's
                    # {kind, from_world, to_world} and reshard_s too)
                    "recoveries": [
                        {k: r.get(k) for k in ("tier", "snapshot_step",
                                               "steps_lost", "restore_s",
                                               "reshard_s", "resize")}
                        for r in reasons if r.get("tier")],
                    "_window": (a["end_wall_s"], b["start_wall_s"]),
                }
                all_gaps.append(entry)
                if reasons or gap_s > 1.0:
                    # a named restart is real at any gap size (fast CPU
                    # restarts measure in ms); an UNNAMED sub-second gap
                    # is just back-to-back engine re-init — charging
                    # ~0 s is harmless, but listing it as a "restart"
                    # would be noise
                    restarts.append(entry)
        per_rank[rank] = {
            "sessions": len(ledgers),
            "buckets_us": buckets,
            "wall_s": sum(buckets.values()) / 1e6,
            "ledgers": ledgers,
        }

    # second-chance matching: a record whose ts fell outside every gap's
    # exact ±1 s window (clock-anchor wobble, a span flushed late under
    # load) still names real downtime — attach it to the NEAREST gap,
    # loudly, instead of silently dropping its annotation
    for r in restart_log:
        if not isinstance(r.get("ts"), (int, float)) or id(r) in matched_ids:
            continue
        best = None
        for g in all_gaps:
            lo, hi = g["_window"]
            d = max(lo - r["ts"], r["ts"] - hi, 0.0)
            if best is None or d < best[0]:
                best = (d, g)
        if best is None or best[0] > 30.0:
            continue
        d, g = best
        g["reasons"].append(r.get("error", "?"))
        if r.get("tier"):
            g["recoveries"].append(
                {k: r.get(k) for k in ("tier", "snapshot_step", "steps_lost",
                                       "restore_s", "reshard_s", "resize")})
        if g not in restarts:
            restarts.append(g)
        warnings.append(
            f"restart record {r.get('error', '?')!r} missed every gap's "
            f"exact window by {d:.1f}s — attached to the nearest gap "
            f"(rank {g['rank']}, before {os.path.basename(g['before'])})")
    restarts.sort(key=lambda g: (g["rank"], g["_window"][0]))
    for g in all_gaps:
        if g["gap_s"] > 1.0 and not g["reasons"]:
            # still charged (a restart without a restart_log —
            # launcher-level restarts, a dead rank 0 — is real
            # downtime), but LOUDLY: if these are two unrelated
            # runs sharing an output dir, the charge is bogus
            warnings.append(
                f"rank {g['rank']}: {g['gap_s']:.1f}s gap before "
                f"{os.path.basename(g['before'])} has NO matching "
                "restart_log record — charged to `restart`; if "
                "these sessions are unrelated runs sharing an "
                "output dir, point the goodput report at one run's "
                "sessions only")
        g.pop("_window", None)

    fleet = sum_buckets([pr["buckets_us"] for pr in per_rank.values()])
    buckets_s = {b: v / 1e6 for b, v in fleet.items()}
    return {
        "ranks": sorted(per_rank),
        "sessions": len(sessions),
        "per_rank": per_rank,
        "buckets_s": buckets_s,
        "fleet_seconds": sum(buckets_s.values()),
        "goodput_fraction": goodput_fraction(fleet),
        "restarts": restarts,
        "warnings": warnings,
    }


# ------------------------------------------------------------------ render
def _fmt_s(s: float) -> str:
    return f"{s:.2f} s" if s < 120 else f"{s/60:.1f} min"


def render_goodput_report(report: Dict[str, Any],
                          source: Optional[str] = None) -> str:
    """The "where did my fleet-seconds go" table."""
    out = ["goodput report" + (f": {source}" if source else "")]
    if not report["ranks"]:
        out.append("no usable session traces found")
        for w in report["warnings"]:
            out.append(f"  warning: {w}")
        return "\n".join(out)
    out.append(f"{len(report['ranks'])} rank(s), {report['sessions']} "
               f"session(s), {_fmt_s(report['fleet_seconds'])} fleet time")
    gf = report["goodput_fraction"]
    if gf is not None:
        good = sum(report["buckets_s"].get(b, 0.0) for b in GOODPUT_BUCKETS)
        out.append(f"goodput: {100.0 * gf:.1f}%  ({_fmt_s(good)} compute of "
                   f"{_fmt_s(report['fleet_seconds'])})")
    out.append("")
    total = report["fleet_seconds"] or 1.0
    rows = [("bucket", "fleet-seconds", "share")]
    for b in sorted(BUCKETS, key=lambda b: -report["buckets_s"].get(b, 0.0)):
        v = report["buckets_s"].get(b, 0.0)
        if v <= 0:
            continue
        rows.append((b, f"{v:.2f}", f"{100.0 * v / total:.1f}%"))
    widths = [max(len(r[i]) for r in rows) for i in range(3)]
    for i, r in enumerate(rows):
        out.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
        if i == 0:
            out.append("  ".join("-" * w for w in widths))
    if report["restarts"]:
        out.append("")
        tot = sum(r["gap_s"] for r in report["restarts"])
        out.append(f"restart downtime: {len(report['restarts'])} gap(s), "
                   f"{_fmt_s(tot)} total")
        for i, r in enumerate(report["restarts"], 1):
            line = (f"  gap {i}: {_fmt_s(r['gap_s'])} on rank {r['rank']} "
                    f"(before {os.path.basename(r['before'])})")
            if r["reasons"]:
                line += " — " + "; ".join(r["reasons"])
            for rec in r.get("recoveries") or []:
                rz = rec.get("resize") or {}
                line += (f" [recovered from {rec.get('tier', '?')} tier"
                         + (f" @step {rec['snapshot_step']}"
                            if rec.get("snapshot_step") is not None else "")
                         + (f", {rec['steps_lost']} step(s) lost"
                            if rec.get("steps_lost") is not None else "")
                         + (f", restore {rec['restore_s']:.3g}s"
                            if rec.get("restore_s") is not None else "")
                         + (f", {rz.get('kind', 'resize')} "
                            f"{rz.get('from_world', '?')}->"
                            f"{rz.get('to_world', '?')} resharded"
                            + (f" in {rec['reshard_s']:.3g}s"
                               if rec.get("reshard_s") is not None else "")
                            if rz else "")
                         + "]")
            out.append(line)
    if report["warnings"]:
        out.append("")
        for w in report["warnings"]:
            out.append(f"warning: {w}")
    return "\n".join(out)


def render_session_table(led: Dict[str, Any],
                         source: Optional[str] = None) -> str:
    """One session's bucket table."""
    out = ["goodput (latest session" + (f": {source}" if source else "") + ")"]
    buckets = led["buckets"]
    total = sum(buckets.values()) or 1.0
    gf = goodput_fraction(buckets)
    if gf is not None:
        out.append(f"  goodput: {100.0 * gf:.1f}% of "
                   f"{_fmt_s(led['wall_us'] / 1e6)} "
                   f"({len(led.get('steps', []))} step(s))")
    for b in sorted(BUCKETS, key=lambda b: -buckets.get(b, 0.0)):
        v = buckets.get(b, 0.0)
        if v <= 0:
            continue
        out.append(f"  {b:<16} {_fmt_s(v / 1e6):>12}  "
                   f"({100.0 * v / total:.1f}%)")
    tb = top_badput(buckets)
    if tb is not None:
        out.append(f"  top badput: {tb[0]} ({100.0 * tb[1] / total:.1f}%)")
    return "\n".join(out)
