"""The cross-rank incident report (``ds_incident``).

Counterpart of ``deepspeed_tpu/blackbox/incident.py``. Run as ``python -m
deepspeed_tpu_torch.blackbox.incident report DIR... [--json] | list [DIR]
| snap --pid PID``. It merges per-rank incident bundles into one timeline
ordered by cause, names the first cause, and prices the incident in
fleet-seconds of restart downtime.

Standard library only at the top of the module, so it runs on a
responder's machine without torch when loaded from its file; the clock
alignment (``profiling/aggregate.py``) and the goodput ledger
(``goodput/report.py``) are imported inside the functions that use them.

What degrades, and how: torn JSONL tails, missing ranks, two bundles
claiming one rank, bundles of one rank that disagree on the config
fingerprint, overlapping sessions and mixed schema versions each add a
warning and the report goes on; the timeline is never made up, and the
alignment falls back from offsets matched on collectives to the raw epoch
anchors when the trace tails hold no evidence.

Two faults of the JAX ``incident_cost`` are not repeated here: it reads the
job report's ``fleet_seconds`` (a float) as a dict of buckets, so with
session traces present its cost is always unknown (the port reads the
``restart`` entry of ``buckets_s``), and it takes a recovery only from a
nested ``recovery`` dict, which no restart record the elastic agent writes
has (the port also reads the agent's flat ``tier``, ``snapshot_step``,
``steps_lost`` and ``restore_s``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

# telemetry.events.SCHEMA_VERSION, repeated so that this module needs no
# package import; a test holds the two equal
SCHEMA_VERSION = 1

_SEVERITY_RANK = {"debug": 0, "info": 1, "warning": 2, "error": 3, "critical": 4}

# the restart record's recovery fields, as the elastic agent stamps them
_RECOVERY_KEYS = ("tier", "snapshot_step", "steps_lost", "restore_s", "reshard_s", "resize")


def _sev(s: Any) -> int:
    return _SEVERITY_RANK.get(str(s).lower(), -1)


# --------------------------------------------------------------- discovery
def discover_bundles(paths: List[str], warnings: List[str]) -> List[str]:
    """The bundle directories (those with a manifest.json) under ``paths``:
    a bundle itself, an ``incidents/`` directory, or a telemetry output
    directory that holds ``incidents/``. A ``.tmp`` bundle is half
    written and skipped."""
    out: List[str] = []
    seen = set()

    def add(d: str) -> None:
        real = os.path.realpath(d)
        if real not in seen:
            seen.add(real)
            out.append(d)

    for p in paths:
        if not os.path.isdir(p):
            warnings.append(f"{p}: not a directory — skipped")
            continue
        if os.path.isfile(os.path.join(p, "manifest.json")):
            add(p)
            continue
        if os.path.basename(os.path.normpath(p)) == "incidents":
            root = p
        elif os.path.isdir(os.path.join(p, "incidents")):
            root = os.path.join(p, "incidents")
        else:
            warnings.append(f"{p}: no incident bundles found under it")
            continue
        for name in sorted(os.listdir(root)):
            d = os.path.join(root, name)
            if name.endswith(".tmp"):
                warnings.append(f"{d}: half-written bundle (.tmp) — skipped")
                continue
            if os.path.isdir(d) and os.path.isfile(os.path.join(d, "manifest.json")):
                add(d)
    return out


def _read_jsonl(path: str, label: str, warnings: List[str]) -> List[Dict[str, Any]]:
    """Every whole record of a JSONL file; torn or garbled lines are
    counted in a warning, not fatal."""
    if not os.path.isfile(path):
        return []
    records: List[Dict[str, Any]] = []
    torn = 0
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    torn += 1
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
                else:
                    torn += 1
    except OSError as e:
        warnings.append(f"{label}: unreadable ({e})")
        return []
    if torn:
        warnings.append(f"{label}: {torn} torn/unparseable line(s) dropped — the tail "
                        "was cut mid-record (crash during write?)")
    return records


def load_bundle(d: str, warnings: List[str]) -> Optional[Dict[str, Any]]:
    """One bundle's manifest and files; None, with a warning, when its
    manifest cannot be read."""
    label = os.path.basename(os.path.normpath(d))
    try:
        with open(os.path.join(d, "manifest.json"), "r", encoding="utf-8") as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        warnings.append(f"{label}: unreadable manifest ({e}) — bundle skipped")
        return None
    sv = manifest.get("schema_version")
    if sv != SCHEMA_VERSION:
        warnings.append(f"{label}: bundle schema_version={sv!r} != reader's "
                        f"{SCHEMA_VERSION} — mixed-version fleet? fields may be missing")
    tail = lambda name: _read_jsonl(os.path.join(d, name), f"{label}/{name}",  # noqa: E731
                                    warnings)
    events = tail("events.jsonl")
    bad_sv = sum(1 for ev in events if ev.get("schema_version") not in (None, SCHEMA_VERSION))
    if bad_sv:
        warnings.append(f"{label}: {bad_sv} event(s) carry a foreign schema_version — "
                        "merging anyway, but payloads may not parse as expected")
    return {
        "dir": d,
        "label": label,
        "manifest": manifest,
        "rank": manifest.get("rank"),
        "anchor": manifest.get("clock_anchor") or {},
        "events": events,
        "step_tail": tail("step_tail.jsonl"),
        "metrics_tail": tail("metrics_tail.jsonl"),
        "trace_tail": tail("trace_tail.jsonl"),
        "restart": tail("restart_log.jsonl"),
    }


# --------------------------------------------------------------- alignment
def _clock_offsets_s(bundles: List[Dict[str, Any]],
                     warnings: List[str]) -> Tuple[Dict[int, float], str]:
    """Per-rank clock offsets in seconds, from the trace tails' matched
    collectives (``FleetTrace.clock_offsets``, as ``profiling.cli merge``
    aligns); none, with the reason in the mode string, when fewer than
    two ranks have spans or no collective matched."""
    per_rank: Dict[int, List[dict]] = {}
    for b in bundles:
        if b["rank"] is None:
            continue
        spans = [ev for ev in b["trace_tail"] if "_clock_anchor" not in ev and "ts" in ev]
        if spans:
            per_rank.setdefault(int(b["rank"]), []).extend(spans)
    if len(per_rank) < 2:
        return {}, "wall-clock (single rank or no trace tails)"
    try:
        from deepspeed_tpu_torch.profiling.aggregate import FleetTrace
    except ImportError:
        warnings.append("clock alignment unavailable (profiling module not importable) — "
                        "falling back to wall-clock ordering")
        return {}, "wall-clock (no alignment module)"
    ft = FleetTrace()
    for rank, evs in per_rank.items():
        ft.add_rank(rank, evs)
    offsets_us = ft.clock_offsets()
    warnings.extend(f"alignment: {w}" for w in ft.warnings)
    if all(v == 0.0 for v in offsets_us.values()):
        # all zero is the estimator's "no evidence": say so
        return {}, "wall-clock (no matched collectives in trace tails)"
    return ({r: v / 1e6 for r, v in offsets_us.items()},
            "collective-aligned (ds_prof clock offsets)")


# ------------------------------------------------------------------- merge
def _identity_warnings(by_rank: Dict[Any, List[Dict[str, Any]]], warnings: List[str]) -> None:
    """Bundles without a rank, ranks claimed twice, fingerprints that
    disagree, and sessions of one rank that overlap in time."""
    for rank, group in sorted(by_rank.items(), key=lambda kv: (kv[0] is None, kv[0])):
        if rank is None:
            warnings.append(f"{len(group)} bundle(s) carry no rank in their manifest — "
                            "their events merge unaligned")
        elif len(group) > 1:
            warnings.append(
                f"rank {rank} claimed by {len(group)} bundles "
                f"({', '.join(g['label'] for g in group)}) — events deduplicated by "
                "event_id; if these are different runs the timeline may interleave "
                "unrelated sessions")
            if len({g["manifest"].get("config_fingerprint") for g in group}) > 1:
                warnings.append(f"rank {rank}: bundles disagree on config_fingerprint — "
                                "almost certainly different runs; trust nothing across them")
    for rank, group in by_rank.items():
        if rank is None or len(group) < 2:
            continue
        spans = []
        for g in group:
            ts = [ev.get("ts") for ev in g["events"] if isinstance(ev.get("ts"), (int, float))]
            if ts:
                spans.append((min(ts), max(ts), g["label"]))
        spans.sort()
        for a, b in zip(spans, spans[1:]):
            if b[0] < a[1]:
                warnings.append(f"rank {rank}: bundles {a[2]} and {b[2]} overlap in time — "
                                "overlapping sessions, ordering between them is not "
                                "trustworthy")


def merge_bundles(bundles: List[Dict[str, Any]], warnings: List[str]) -> Dict[str, Any]:
    """The bundles' events as one timeline, ordered on aligned time."""
    by_rank: Dict[Any, List[Dict[str, Any]]] = {}
    for b in bundles:
        by_rank.setdefault(b["rank"], []).append(b)
    _identity_warnings(by_rank, warnings)
    # missing ranks, against the widest world size a bundle saw
    worlds = [b["manifest"].get("world_size") for b in bundles
              if isinstance(b["manifest"].get("world_size"), int)]
    ranks_present = sorted({b["rank"] for b in bundles if b["rank"] is not None})
    if worlds and ranks_present:
        world = max(worlds)
        missing = sorted(set(range(world)) - set(ranks_present))
        if missing:
            warnings.append(f"missing bundle(s) for rank(s) {missing} of world_size {world} "
                            "— a dead rank leaves a hole, not a silent lane; first-cause "
                            "covers only the ranks present")

    offsets, align_mode = _clock_offsets_s(bundles, warnings)
    merged: List[Dict[str, Any]] = []
    seen_ids = set()
    for b in bundles:
        off = offsets.get(b["rank"], 0.0) if b["rank"] is not None else 0.0
        for ev in b["events"]:
            eid = ev.get("event_id")
            if eid is not None:
                if eid in seen_ids:
                    continue
                seen_ids.add(eid)
            ts = ev.get("ts")
            merged.append({**ev, "_bundle": b["label"], "_rank": ev.get("rank", b["rank"]),
                           "_ts_aligned": float(ts) - off
                           if isinstance(ts, (int, float)) else None})
    unstamped = sum(1 for e in merged if e["_ts_aligned"] is None)
    if unstamped:
        warnings.append(f"{unstamped} event(s) carry no usable timestamp — appended at "
                        "the end of the timeline, unordered")
    merged.sort(key=lambda e: (e["_ts_aligned"] is None, e["_ts_aligned"] or 0.0,
                               e.get("_rank") if isinstance(e.get("_rank"), int) else 1 << 30))
    return {"timeline": merged, "align_mode": align_mode, "offsets_s": offsets,
            "ranks": ranks_present}


# ------------------------------------------------------------- first cause
_VERDICT_KINDS = ("sdc_verdict", "gray_verdict")


def first_cause(merged: Dict[str, Any], bundles: List[Dict[str, Any]],
                warnings: List[str]) -> Optional[Dict[str, Any]]:
    """The earliest anomaly, strongest evidence first: a verdict that names
    a device, then an event of severity error or worse, then a restart
    record, then the largest skew gauge of the metric tails; else None,
    with a warning."""
    timeline = merged["timeline"]
    for ev in timeline:
        if ev.get("kind") in _VERDICT_KINDS:
            p = ev.get("payload") or {}
            return {"rank": ev.get("_rank"), "device": p.get("device"), "kind": ev.get("kind"),
                    "step": ev.get("step"), "ts": ev.get("_ts_aligned"),
                    "why": f"earliest blaming verdict ({ev.get('kind')} {p.get('kind', '?')})"}
    for ev in timeline:
        if _sev(ev.get("severity")) >= _sev("error"):
            return {"rank": ev.get("_rank"), "device": None, "kind": ev.get("kind"),
                    "step": ev.get("step"), "ts": ev.get("_ts_aligned"),
                    "why": "earliest severity>=error event"}
    restarts = [(rec["ts"], b["rank"], rec) for b in bundles for rec in b["restart"]
                if isinstance(rec.get("ts"), (int, float))]
    if restarts:
        ts, rank, rec = min(restarts, key=lambda t: t[0])
        return {"rank": rank, "device": None, "kind": rec.get("kind", "restart"),
                "step": rec.get("step"), "ts": ts,
                "why": "earliest restart record (no in-ring error evidence)"}
    best = None
    for b in bundles:
        for rec in b["metrics_tail"]:
            name = str(rec.get("name", ""))
            v = rec.get("value")
            if "skew" in name and isinstance(v, (int, float)) and (
                    best is None or abs(v) > abs(best[0])):
                best = (v, b["rank"], name)
    if best is not None:
        return {"rank": best[1], "device": None, "kind": best[2], "step": None, "ts": None,
                "why": f"largest skew gauge |{best[0]:.4g}| "
                       "(weak evidence: no verdicts, errors, or restarts)"}
    warnings.append("no first-cause evidence found (no verdicts, errors, restarts, or skew "
                    "gauges) — refusing to guess")
    return None


# ------------------------------------------------------------------- cost
def _record_recovery(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """A restart record's recovery: its nested ``recovery`` dict, or the
    flat fields the elastic agent stamps."""
    rc = rec.get("recovery")
    if isinstance(rc, dict) and rc.get("tier"):
        return rc
    if rec.get("tier"):
        return {k: rec.get(k) for k in _RECOVERY_KEYS}
    return None


def _recovery_from_restarts(bundles: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    for b in bundles:
        for rec in reversed(b["restart"]):
            rc = _record_recovery(rec)
            if rc is not None:
                return rc
    return None


def incident_cost(bundles: List[Dict[str, Any]], warnings: List[str]) -> Dict[str, Any]:
    """The incident's goodput cost: fleet-seconds of restart downtime,
    from the goodput ledger over the session traces of the telemetry
    directories the bundles live in; else the sum of the bundles' restart
    records (backoff, restore and reshard seconds), a lower bound."""
    out: Dict[str, Any] = {"fleet_seconds": None, "source": None,
                           "recovery": _recovery_from_restarts(bundles)}
    tel_dirs = sorted({os.path.dirname(os.path.dirname(os.path.normpath(b["dir"])))
                       for b in bundles})
    try:
        from deepspeed_tpu_torch.goodput.report import (build_job_report,
                                                        find_session_traces,
                                                        load_restart_log)

        traces = find_session_traces(tel_dirs)
        if traces:
            rep = build_job_report(traces, load_restart_log(tel_dirs))
            restart_s = (rep.get("buckets_s") or {}).get("restart")
            if restart_s is not None:
                out["fleet_seconds"] = round(float(restart_s), 3)
                out["source"] = "goodput ledger (session traces)"
            if out["recovery"] is None:
                recs = [r for g in rep.get("restarts") or [] for r in g.get("recoveries") or []]
                if recs:
                    out["recovery"] = recs[-1]
            return out
    except Exception as e:  # noqa: BLE001 - degrade, never die
        warnings.append(f"goodput ledger unavailable for cost ({e}) — falling back to "
                        "bundle restart records")
    total = 0.0
    n = 0
    for b in bundles:
        for rec in b["restart"]:
            if isinstance(rec.get("backoff_s"), (int, float)):
                total += rec["backoff_s"]
                n += 1
            rc = rec.get("recovery")
            for key in ("restore_s", "reshard_s"):
                v = rc.get(key) if isinstance(rc, dict) else None
                if isinstance(v, (int, float)):
                    total += v
    if n or total:
        out["fleet_seconds"] = round(total, 3)
        out["source"] = "bundle restart records (lower bound)"
    return out


# ------------------------------------------------------------------ report
def build_report(paths: List[str]) -> Dict[str, Any]:
    """The merged report over every bundle under ``paths``."""
    warnings: List[str] = []
    bundles = [b for d in discover_bundles(paths, warnings)
               if (b := load_bundle(d, warnings)) is not None]
    if not bundles:
        return {"bundles": [], "warnings": warnings}
    merged = merge_bundles(bundles, warnings)
    cause = first_cause(merged, bundles, warnings)
    cost = incident_cost(bundles, warnings)
    triggers = sorted(((b["manifest"].get("ts"), b["manifest"].get("trigger"), b["label"],
                        b["rank"]) for b in bundles), key=lambda t: (t[0] is None, t[0]))
    return {
        "bundles": [{"dir": b["dir"], "label": b["label"], "rank": b["rank"],
                     "trigger": b["manifest"].get("trigger"), "events": len(b["events"])}
                    for b in bundles],
        "ranks": merged["ranks"],
        "align_mode": merged["align_mode"],
        "offsets_s": merged["offsets_s"],
        "trigger": {"kind": triggers[0][1], "bundle": triggers[0][2], "rank": triggers[0][3]},
        "timeline": merged["timeline"],
        "first_cause": cause,
        "cost": cost,
        "warnings": warnings,
    }


def _fmt_payload(p: Any, width: int = 72) -> str:
    try:
        s = json.dumps(p, sort_keys=True, default=str)
    except (TypeError, ValueError):
        s = str(p)
    return s if len(s) <= width else s[:width - 3] + "..."


def _recovery_line(rec: Dict[str, Any]) -> str:
    bits = [f"tier={rec.get('tier')}"]
    rs = rec.get("resize")
    if rs:
        bits.append(f"resize {rs.get('from')}->{rs.get('to')}" if isinstance(rs, dict)
                    else f"resize {rs}")
    if rec.get("steps_lost") is not None:
        bits.append(f"steps_lost={rec.get('steps_lost')}")
    return "recovery: " + ", ".join(bits)


def render_report(report: Dict[str, Any], max_events: int = 60) -> str:
    """The report as text: trigger, first cause, recovery, cost, the
    timeline (its middle elided past ``max_events``) and the warnings."""
    lines: List[str] = []
    bundles = report.get("bundles", [])
    if not bundles:
        lines.append("ds_incident: no incident bundles found")
        lines.extend(f"  warning: {w}" for w in report.get("warnings", []))
        return "\n".join(lines)
    lines.append(f"incident report — {len(bundles)} bundle(s), "
                 f"rank(s) {report.get('ranks', [])}")
    trig = report.get("trigger")
    if trig:
        lines.append(f"trigger: {trig['kind']} (bundle {trig['bundle']}, rank {trig['rank']})")
    cause = report.get("first_cause")
    if cause:
        where = f"rank {cause.get('rank')}"
        if cause.get("device") is not None:
            where += f" device {cause['device']}"
        at = f" at step {cause['step']}" if cause.get("step") is not None else ""
        lines.append(f"first cause: {where} — {cause.get('kind')}{at} [{cause.get('why')}]")
    else:
        lines.append("first cause: undetermined (see warnings)")
    cost = report.get("cost") or {}
    if cost.get("recovery"):
        lines.append(_recovery_line(cost["recovery"]))
    if cost.get("fleet_seconds") is not None:
        lines.append(f"cost: {cost['fleet_seconds']} fleet-seconds of restart downtime "
                     f"[{cost.get('source')}]")
    else:
        lines.append("cost: unknown (no session traces or restart records)")
    timeline = report.get("timeline", [])
    lines.append(f"timeline ({len(timeline)} events, {report.get('align_mode')}):")
    t0 = next((e["_ts_aligned"] for e in timeline if e.get("_ts_aligned") is not None), None)
    shown = timeline if len(timeline) <= max_events else \
        timeline[:max_events // 2] + [None] + timeline[-max_events // 2:]
    for ev in shown:
        if ev is None:
            lines.append(f"  ... {len(timeline) - max_events} more ...")
            continue
        ts = ev.get("_ts_aligned")
        rel = f"+{ts - t0:9.3f}s" if ts is not None and t0 is not None else "      ?.???s"
        step = f" step={ev.get('step')}" if ev.get("step") is not None else ""
        lines.append(f"  {rel} rank{ev.get('_rank')} "
                     f"{str(ev.get('severity', '?')).upper():8s} "
                     f"{ev.get('kind')}{step} {_fmt_payload(ev.get('payload'))}")
    lines.extend(f"warning: {w}" for w in report.get("warnings", []))
    return "\n".join(lines)


# --------------------------------------------------------------------- CLI
def _cmd_report(args: List[str]) -> int:
    paths = [a for a in args if not a.startswith("--")]
    if not paths:
        print("usage: ds_incident report DIR... [--json]")
        return 2
    report = build_report(paths)
    if "--json" in args:
        print(json.dumps(report, indent=1, default=str))
    else:
        print(render_report(report))
    return 0 if report.get("bundles") else 1


def _cmd_list(args: List[str]) -> int:
    warnings: List[str] = []
    dirs = discover_bundles(args or ["."], warnings)
    for d in dirs:
        b = load_bundle(d, warnings)
        if b is not None:
            m = b["manifest"]
            print(f"{b['label']}: trigger={m.get('trigger')} rank={b['rank']} "
                  f"events={len(b['events'])} ts={m.get('ts')}")
    for w in warnings:
        print(f"warning: {w}")
    return 0 if dirs else 1


def _cmd_snap(args: List[str]) -> int:
    import signal

    pid = None
    if "--pid" in args:
        try:
            pid = int(args[args.index("--pid") + 1])
        except (IndexError, ValueError):
            print("usage: ds_incident snap --pid PID")
            return 2
    if pid is None:
        print("usage: ds_incident snap --pid PID   (sends SIGUSR1; the blackbox recorder "
              "in that process dumps stacks + an incident bundle)")
        return 2
    if not hasattr(signal, "SIGUSR1"):
        print("ds_incident snap: SIGUSR1 unavailable on this platform")
        return 1
    os.kill(pid, signal.SIGUSR1)
    print(f"sent SIGUSR1 to pid {pid}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: ds_incident {report DIR... [--json] | list [DIR] | snap --pid PID}")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    commands = {"report": _cmd_report, "list": _cmd_list, "snap": _cmd_snap}
    if cmd not in commands:
        print(f"ds_incident: unknown command {cmd!r}")
        return 2
    return commands[cmd](rest)


if __name__ == "__main__":
    raise SystemExit(main())
