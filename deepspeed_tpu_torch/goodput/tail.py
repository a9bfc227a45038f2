"""JSONL tail-follower: the one reader ``goodput.top`` follows a run with.

Counterpart of ``deepspeed_tpu/goodput/tail.py``. The telemetry JSONL
exporter appends one object per metric per flush; a live viewer needs the
records that are new since its last look, whatever happened to the file:
it may not exist yet (no flush so far), may be truncated (a fresh run in
the same output directory), rotated (same path, new inode), or end in a
torn line (read mid-append). Offsets are in bytes, so multi-byte
characters cannot upset the seek arithmetic. The status lines of the
rewind, resize, sdc, gray, roofline and incident series read gauges and
counters only and render whatever a run exported. Standard library only.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

# resilience/rewind.py's TIER_CODES, kept here: this module is standard
# library only
REWIND_TIERS = {0: "none", 1: "ram", 2: "emergency", 3: "disk"}


def labeled_key(name: str, labels: Optional[Dict[str, str]]) -> str:
    """The key of a labeled series, ``name{k=v,...}`` with the labels
    sorted. Every renderer that builds or parses such keys goes through
    this pair, so the encoding cannot drift between the views."""
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}"
                                 for k, v in sorted(labels.items())) + "}"


def parse_label(key: str, label: str) -> Optional[str]:
    """Value of ``label`` inside a :func:`labeled_key`-encoded key, or
    None when absent."""
    lo = key.find("{")
    if lo < 0:
        return None
    for part in key[lo + 1:].rstrip("}").split(","):
        k, _, v = part.partition("=")
        if k == label:
            return v
    return None


def render_rewind_line(gauges: Dict[str, float], counters: Dict[str, float],
                       step=None) -> Optional[str]:
    """The rewind status line: the RAM tier's snapshot and its age, the
    emergency saves and the last recovery (tier, steps lost, restore
    time)."""
    if not any(k.startswith("rewind/") for k in gauges) and \
            not any(k.startswith("rewind/") for k in counters):
        return None
    parts = ["rewind:"]
    snap_step = gauges.get("rewind/ram_snapshot_step")
    if snap_step is not None:
        seg = f"ram tier @step {int(snap_step)}"
        if step is not None:
            seg += f" (age {max(0, int(step) - int(snap_step))} step(s))"
        held = gauges.get("rewind/ram_snapshots_held")
        if held:
            seg += f", {int(held)} held"
        mb = gauges.get("rewind/ram_bytes")
        if mb:
            seg += f", {mb / 2**20:.1f} MiB"
        parts.append(seg)
    else:
        parts.append("ram tier empty")
    em = sum(v for k, v in counters.items()
             if k.startswith("rewind/emergency_saves"))
    if em:
        parts.append(f"emergency saves {int(em)}")
    tier_code = gauges.get("rewind/last_recovery_tier")
    if tier_code:
        seg = ("last recovery: "
               f"{REWIND_TIERS.get(int(tier_code), '?')} tier")
        if gauges.get("rewind/last_recovery_snapshot_step") is not None:
            seg += f" @step {int(gauges['rewind/last_recovery_snapshot_step'])}"
        if gauges.get("rewind/last_recovery_steps_lost") is not None:
            seg += f", {int(gauges['rewind/last_recovery_steps_lost'])} step(s) lost"
        if gauges.get("rewind/last_recovery_restore_s") is not None:
            seg += f", restore {gauges['rewind/last_recovery_restore_s']:.3g}s"
        parts.append(seg)
    return "  ".join(parts)


def render_resize_line(gauges: Dict[str, float],
                       counters: Dict[str, float]) -> Optional[str]:
    """The resize status line: the run's resize events by kind and the
    last one's geometry and reshard time."""
    events = {k: v for k, v in counters.items()
              if k.startswith("elasticity/resizes")}
    last_to = gauges.get("elasticity/last_resize_to")
    if not events and last_to is None:
        return None
    parts = ["resize:"]
    total = int(sum(events.values()))
    by_kind = []
    for k, v in sorted(events.items()):
        by_kind.append(f"{int(v)} {parse_label(k, 'kind') or '?'}")
    parts.append(f"{total} event(s)" + (f" ({', '.join(by_kind)})"
                                        if by_kind else ""))
    if last_to is not None:
        seg = (f"last {int(gauges.get('elasticity/last_resize_from', 0))}"
               f"->{int(last_to)} device(s)")
        if gauges.get("elasticity/last_reshard_s") is not None:
            seg += f", reshard {gauges['elasticity/last_reshard_s']:.3g}s"
        parts.append(seg)
    return "  ".join(parts)


def render_sdc_line(gauges: Dict[str, float],
                    counters: Dict[str, float]) -> Optional[str]:
    """The silent-data-corruption status line: the audit cadence, the last
    clean step, the verdicts by blamed device, evictions, poisoned
    snapshots and rewinds. None when the run exported no ``sdc/`` series."""
    if not any(k.startswith("sdc/") for k in gauges) and \
            not any(k.startswith("sdc/") for k in counters):
        return None
    parts = ["sdc:"]
    interval = gauges.get("sdc/audit_interval")
    if interval:
        parts.append(f"audit every {int(interval)} step(s)")
    clean = gauges.get("sdc/last_clean_step")
    if clean is not None and clean >= 0:
        parts.append(f"last clean @step {int(clean)}")
    verdicts = {k: v for k, v in counters.items()
                if k.startswith("sdc/verdicts")}
    if verdicts:
        by_dev = ", ".join(
            f"{int(v)}x dev{parse_label(k, 'device') or '?'}"
            for k, v in sorted(verdicts.items()))
        seg = f"VERDICTS {int(sum(verdicts.values()))} ({by_dev})"
        vd = gauges.get("sdc/last_verdict_device")
        vs = gauges.get("sdc/last_verdict_step")
        if vd is not None and vs is not None:
            seg += f", last blamed dev{int(vd)} @step {int(vs)}"
        parts.append(seg)
    else:
        parts.append("no verdicts")
    ev = sum(v for k, v in counters.items() if k.startswith("sdc/evictions"))
    if ev:
        parts.append(f"evicted {int(ev)} device(s)")
    poisoned = sum(v for k, v in counters.items()
                   if k.startswith("sdc/poisoned_snapshots"))
    if poisoned:
        parts.append(f"poisoned {int(poisoned)} snapshot(s)")
    rewinds = sum(v for k, v in counters.items()
                  if k.startswith("resilience/sdc_rewinds"))
    if rewinds:
        parts.append(f"sdc rewinds {int(rewinds)}")
    return "  ".join(parts)


def render_gray_line(gauges: Dict[str, float],
                     counters: Dict[str, float]) -> Optional[str]:
    """The fail-slow status line: the suspicion score against the blame
    threshold, the suspect, the probes, verdicts by blamed device,
    evictions and warnings. None when the run exported no ``gray/``
    series."""
    if not any(k.startswith("gray/") for k in gauges) and \
            not any(k.startswith("gray/") for k in counters):
        return None
    parts = ["gray:"]
    susp = gauges.get("gray/suspicion")
    if susp is not None:
        seg = f"suspicion {susp:.2f}"
        thr = gauges.get("gray/blame_threshold")
        if thr is not None:
            seg += f"/{thr:.2f}"
        parts.append(seg)
    suspect = gauges.get("gray/suspect_device")
    if suspect is not None and suspect >= 0:
        parts.append(f"suspect dev{int(suspect)}")
    probes = sum(v for k, v in counters.items()
                 if k.startswith("gray/probes"))
    if probes:
        parts.append(f"{int(probes)} probe(s)")
    verdicts = {k: v for k, v in counters.items()
                if k.startswith("gray/verdicts")}
    if verdicts:
        by_dev = ", ".join(
            f"{int(v)}x dev{parse_label(k, 'device') or '?'}"
            for k, v in sorted(verdicts.items()))
        seg = f"VERDICTS {int(sum(verdicts.values()))} ({by_dev})"
        vd = gauges.get("gray/last_verdict_device")
        vs = gauges.get("gray/last_verdict_step")
        if vd is not None and vs is not None:
            seg += f", last blamed dev{int(vd)} @step {int(vs)}"
        parts.append(seg)
    else:
        parts.append("no verdicts")
    ev = sum(v for k, v in counters.items()
             if k.startswith("gray/evictions"))
    if ev:
        parts.append(f"evicted {int(ev)} device(s)")
    warns = sum(v for k, v in counters.items()
                if k.startswith("gray/warnings"))
    if warns:
        parts.append(f"{int(warns)} warning(s)")
    return "  ".join(parts)


def render_roofline_line(gauges: Dict[str, float],
                         counters: Dict[str, float]) -> Optional[str]:
    """The roofline status line: the analytic MFU ceiling against the
    measured MFU (``goodput/mfu``), the predicted step time and its
    memory-bound share. None when the run exported no ``roofline/``
    gauges."""
    if not any(k.startswith("roofline/") for k in gauges):
        return None
    parts = ["roofline:"]
    ceiling = gauges.get("roofline/mfu_ceiling")
    if ceiling is not None:
        seg = f"mfu ceiling {ceiling:.3f}"
        measured = gauges.get("goodput/mfu")
        if measured is not None:
            seg += (f" vs measured {measured:.3f} "
                    f"(gap {max(0.0, ceiling - measured):.3f})")
        parts.append(seg)
    pred = gauges.get("roofline/predicted_step_us")
    if pred is not None:
        parts.append(f"predicted step {pred / 1e3:.1f}ms")
    mem = gauges.get("roofline/memory_bound_share")
    if mem is not None:
        parts.append(f"{mem:.0%} memory-bound")
    agree = gauges.get("roofline/flops_vs_xla")
    if agree is not None:
        parts.append(f"model/xla flops {agree:.3f}")
    return "  ".join(parts)


def render_incident_line(gauges: Dict[str, float],
                         counters: Dict[str, float]) -> Optional[str]:
    """The incident status line: the flight recorder's events by severity,
    its ring fill and the incident bundles by trigger. None when the run
    exported no ``blackbox/`` series."""
    if not any(k.startswith("blackbox/") for k in gauges) and \
            not any(k.startswith("blackbox/") for k in counters):
        return None
    parts = ["incident:"]
    events = {k: v for k, v in counters.items()
              if k.startswith("blackbox/events")}
    total = int(sum(events.values()))
    errors = int(sum(v for k, v in events.items()
                     if parse_label(k, "severity") in ("error", "critical")))
    seg = f"{total} event(s)"
    if errors:
        seg += f" ({errors} error)"
    parts.append(seg)
    fill = gauges.get("blackbox/ring_fill")
    if fill is not None:
        parts.append(f"ring {int(fill)}")
    bundles = {k: v for k, v in counters.items()
               if k.startswith("blackbox/bundles")}
    nb = int(sum(bundles.values()))
    if nb:
        seg = f"BUNDLES {nb}"
        # the trigger label of the (alphabetically last-touched) series
        # is the best stdlib guess at the latest trigger; exact ordering
        # lives in the bundles themselves
        triggers = sorted({parse_label(k, "trigger") or "?"
                           for k in bundles})
        seg += " (" + ", ".join(triggers) + ")"
        parts.append(seg)
    else:
        parts.append("no bundles")
    return "  ".join(parts)


class JSONLTailer:
    """Incremental reader of an append-mostly JSONL file.

    ``poll()`` returns the records appended since the last poll. On
    truncation or rotation (size shrank / inode changed) the reader
    starts over from offset 0 — the new file IS the new truth, and the
    caller's accumulated state should be rebuilt from what poll returns
    (records re-delivered after a reset are the new file's content, not
    duplicates of the old one). A torn final line is left unconsumed
    until its newline arrives; a line that is complete but malformed is
    counted in ``bad_lines`` and skipped.
    """

    def __init__(self, path: str):
        self.path = path
        self._pos = 0
        self._sig: Optional[Tuple[int, int]] = None   # (st_dev, st_ino)
        self.bad_lines = 0
        self.resets = 0

    def poll(self) -> List[dict]:
        try:
            st = os.stat(self.path)
        except OSError:
            if self._sig is not None:       # file vanished: treat as rotation
                self._sig, self._pos = None, 0
                self.resets += 1
            return []
        sig = (st.st_dev, st.st_ino)
        if self._sig is not None and (sig != self._sig
                                      or st.st_size < self._pos):
            self._pos = 0                   # rotated or truncated: start over
            self.resets += 1
        self._sig = sig
        if st.st_size <= self._pos:
            return []
        with open(self.path, "rb") as f:
            f.seek(self._pos)
            chunk = f.read()
        end = chunk.rfind(b"\n")
        if end < 0:
            return []                       # only a torn line so far
        consumed = chunk[:end + 1]
        self._pos += len(consumed)
        out = []
        for raw in consumed.splitlines():
            raw = raw.strip()
            if not raw:
                continue
            try:
                rec = json.loads(raw.decode("utf-8", errors="replace"))
            except (ValueError, UnicodeDecodeError):
                self.bad_lines += 1
                continue
            if isinstance(rec, dict):
                out.append(rec)
            else:
                self.bad_lines += 1
        return out


class MetricsFollower:
    """Last-record-per-series view over a tailed telemetry metrics.jsonl —
    the same (kind, name, labels) keying ``load_metrics_records`` uses,
    kept live. A tailer reset (rotation/truncation) clears the view."""

    def __init__(self, path: str):
        self.tailer = JSONLTailer(path)
        self._last = {}
        self._order = []

    @staticmethod
    def _key(rec: dict):
        try:
            return (rec["kind"], rec["name"],
                    tuple(sorted((rec.get("labels") or {}).items())))
        except (KeyError, TypeError):
            return None

    def poll(self) -> bool:
        """Absorb new records; True when anything changed — including a
        rotation/truncation reset that delivered nothing yet (the viewer
        must drop the dead file's numbers, not keep displaying them)."""
        resets = self.tailer.resets
        recs = self.tailer.poll()
        if self.tailer.resets != resets:
            self._last, self._order = {}, []
        changed = bool(recs) or self.tailer.resets != resets
        for rec in recs:
            key = self._key(rec)
            if key is None:
                self.tailer.bad_lines += 1
                continue
            if key not in self._last:
                self._order.append(key)
            self._last[key] = rec
        return changed

    def records(self) -> List[dict]:
        return [self._last[k] for k in self._order]


def follow_loop(path: str, render: Callable[[List[dict]], str],
                interval: float = 2.0, max_polls: Optional[int] = None,
                out=None, clear: Optional[bool] = None,
                on_render=None) -> int:
    """The tail loop: poll the follower, render on a change (and on the
    first poll, so an empty file still shows a frame), repaint with ANSI
    codes on a terminal, sleep between polls. ``max_polls`` bounds the
    loop; ``on_render(follower, out)`` runs after each write (a viewer
    reports the malformed-line count its own way)."""
    out = sys.stdout if out is None else out
    clear = out.isatty() if clear is None else clear
    follower = MetricsFollower(path)
    polls = 0
    first = True
    while max_polls is None or polls < max_polls:
        changed = follower.poll()
        if changed or first:
            text = render(follower.records())
            if clear:
                out.write("\x1b[2J\x1b[H")
            out.write(text + "\n")
            out.flush()
            if on_render is not None:
                on_render(follower, out)
            first = False
        polls += 1
        if max_polls is None or polls < max_polls:
            time.sleep(interval)
    return 0
