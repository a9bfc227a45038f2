"""``python -m deepspeed_tpu_torch.goodput.top``: the live view of a run.

Counterpart of ``deepspeed_tpu/goodput/top.py`` (``bin/ds_top``). Tails a
telemetry directory's ``metrics.jsonl`` (rotation- and truncation-safe,
``goodput/tail.py``) and draws one frame per change: the step and its
time, samples/s, MFU, goodput with the top badput bucket and the badput
bar, the comm latency skew, the status lines of the series a run exported
and, with ``serving/*`` series, the serving line. Standard library only.

Usage: ``python -m deepspeed_tpu_torch.goodput.top DIR [--once]
[--interval S] [--frames N]``; it calls itself ``ds_top``, as the JAX tool
does.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Dict, List, Optional

from deepspeed_tpu_torch.goodput.tail import (MetricsFollower, labeled_key,
                                        render_gray_line,
                                        render_incident_line,
                                        render_resize_line,
                                        render_rewind_line,
                                        render_roofline_line,
                                        render_sdc_line)
from deepspeed_tpu_torch.goodput.taxonomy import GOODPUT_BUCKETS


# ------------------------------------------------------------- summarizing
def summarize(records: List[dict]) -> Dict[str, Any]:
    """Pull the frame's numbers out of a last-per-series record list."""
    gauges: Dict[str, float] = {}
    hists: Dict[str, dict] = {}
    counters: Dict[str, float] = {}
    fractions: Dict[str, float] = {}
    comm_skew = None
    serving: Dict[str, Any] = {}
    step = None
    ts = None
    for rec in records:
        name = rec.get("name", "")
        labels = rec.get("labels") or {}
        kind = rec.get("kind")
        if rec.get("step") is not None:
            step = max(step or 0, rec["step"])
        if rec.get("ts") is not None:
            ts = max(ts or 0.0, rec["ts"])
        if name == "goodput/fraction" and "bucket" in labels:
            fractions[labels["bucket"]] = rec.get("value", 0.0)
        elif kind == "gauge":
            gauges[name] = rec.get("value", 0.0)
        elif kind == "histogram":
            hists[name] = rec
            if name == "comm/op_latency_seconds":
                p50 = rec.get("p50") or 0.0
                mx = rec.get("max") or 0.0
                if p50 > 0:
                    ratio = mx / p50
                    if comm_skew is None or ratio > comm_skew[0]:
                        comm_skew = (ratio, labels.get("op", "?"),
                                     p50, mx)
        elif kind == "counter":
            counters[labeled_key(name, labels)] = rec.get("value", 0.0)
        if name.startswith("serving/"):
            # e.g. shed{reason=...}: one entry per labelset
            serving[labeled_key(name[len("serving/"):], labels)] = rec
    return {"step": step, "ts": ts, "gauges": gauges, "hists": hists,
            "counters": counters, "fractions": fractions,
            "comm_skew": comm_skew, "serving": serving}


_SERVING_STATES = {0: "starting", 1: "ready", 2: "degraded", 3: "draining",
                   4: "dead"}


def _bar(frac: float, width: int = 24) -> str:
    n = max(0, min(width, int(round(frac * width))))
    return "#" * n + "." * (width - n)


def render_frame(records: List[dict], source: Optional[str] = None,
                 now: Optional[float] = None) -> str:
    """One frame of the live view (also the --once output)."""
    s = summarize(records)
    now = time.time() if now is None else now
    out = []
    head = "ds_top" + (f" — {source}" if source else "")
    if s["step"] is not None:
        head += f"  step {s['step']}"
    if s["ts"]:
        age = max(0.0, now - s["ts"])
        head += f"  (flushed {age:.0f}s ago)"
    out.append(head)
    if not records:
        out.append("waiting for metrics.jsonl ... (telemetry block enabled, "
                   "first flush pending?)")
        return "\n".join(out)

    g = s["gauges"]
    line = []
    if "goodput/step_wall_s" in g:
        line.append(f"step time {g['goodput/step_wall_s']:.3f}s")
    elif s["hists"].get("goodput/step_wall_seconds"):
        line.append(f"step time p50 "
                    f"{s['hists']['goodput/step_wall_seconds'].get('p50', 0):.3f}s")
    if "train/samples_per_sec" in g:
        line.append(f"samples/s {g['train/samples_per_sec']:.1f}")
    if "goodput/mfu" in g:
        line.append(f"MFU {g['goodput/mfu']:.3f}")
    if "train/loss" in g:
        line.append(f"loss {g['train/loss']:.4f}")
    if line:
        out.append("  ".join(line))

    if "goodput/goodput_fraction" in g:
        gf = g["goodput/goodput_fraction"]
        out.append(f"goodput {100.0 * gf:5.1f}%  [{_bar(gf)}]"
                   + (f"  job {100.0 * g['goodput/job_goodput_fraction']:.1f}%"
                      if "goodput/job_goodput_fraction" in g else ""))
        bad = [(b, f) for b, f in s["fractions"].items()
               if b not in GOODPUT_BUCKETS and f > 0.0005]
        bad.sort(key=lambda kv: -kv[1])
        if bad:
            out.append("badput: " + "  ".join(
                f"{b} {100.0 * f:.1f}%" for b, f in bad))
    elif s["fractions"] or any(k.startswith("goodput/") for k in g):
        out.append("goodput: (no complete step yet)")
    else:
        out.append("goodput: n/a — enable the ds_config `goodput` block")

    rew = render_rewind_line(g, s["counters"], step=s["step"])
    if rew:
        out.append(rew)
    rz = render_resize_line(g, s["counters"])
    if rz:
        out.append(rz)
    sdc = render_sdc_line(g, s["counters"])
    if sdc:
        out.append(sdc)
    gray = render_gray_line(g, s["counters"])
    if gray:
        out.append(gray)
    roof = render_roofline_line(g, s["counters"])
    if roof:
        out.append(roof)
    inc = render_incident_line(g, s["counters"])
    if inc:
        out.append(inc)

    if s["comm_skew"] is not None:
        ratio, op, p50, mx = s["comm_skew"]
        if ratio >= 1.05:
            out.append(f"comm skew: {op} max/p50 {ratio:.1f}x "
                       f"({p50 * 1e3:.2f}ms -> {mx * 1e3:.2f}ms; fleet-wide "
                       "skew needs `ds_prof merge`)")

    srv = s["serving"]
    if srv:
        state = srv.get("state")
        state_name = _SERVING_STATES.get(
            int(state.get("value", -1)), "?") if state else "?"
        parts = [f"serving: {state_name}"]
        if "queue_depth" in srv:
            parts.append(f"queue {int(srv['queue_depth'].get('value', 0))}")
        if "admitted" in srv:
            parts.append(f"admitted {int(srv['admitted'].get('value', 0))}")
        ttft = srv.get("ttft_seconds")
        if ttft and ttft.get("count"):
            parts.append(f"ttft p50 {ttft.get('p50', 0):.3g}s "
                         f"p99 {ttft.get('p99', 0):.3g}s")
        frac = srv.get("ttft_deadline_fraction")
        if frac and frac.get("count"):
            parts.append(f"ttft/deadline p99 {frac.get('p99', 0):.2f}")
        shed = sum(v.get("value", 0) for k, v in srv.items()
                   if k.startswith("shed"))
        if shed:
            parts.append(f"shed {int(shed)}")
        out.append("  ".join(parts))
    return "\n".join(out)


# ------------------------------------------------------------------- main
def follow(path: str, interval: float = 2.0, max_frames: Optional[int] = None,
           out=None, clear: Optional[bool] = None) -> int:
    """The live loop: ``tail.follow_loop`` drawing :func:`render_frame`,
    the malformed-line count written under the frame."""
    from deepspeed_tpu_torch.goodput.tail import follow_loop

    def _note_bad_lines(follower, stream):
        if follower.tailer.bad_lines:
            stream.write(f"({follower.tailer.bad_lines} malformed "
                         "line(s) skipped)\n")
            stream.flush()

    return follow_loop(path, lambda recs: render_frame(recs, source=path),
                       interval=interval, max_polls=max_frames, out=out,
                       clear=clear, on_render=_note_bad_lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="ds_top",
        description="live fleet view over a telemetry output dir "
                    "(step time, samples/sec, MFU, goodput %, top badput "
                    "bucket, comm skew, serving SLO line)")
    parser.add_argument("path", help="metrics.jsonl or the telemetry "
                                     "output dir")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="poll interval in seconds (default 2)")
    parser.add_argument("--once", action="store_true",
                        help="print one frame and exit (no tail loop)")
    parser.add_argument("--frames", type=int, default=None,
                        help="exit after N poll cycles (default: forever)")
    args = parser.parse_args(argv)
    path = args.path
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.jsonl")
    if args.once:
        return follow(path, interval=0.0, max_frames=1, clear=False)
    try:
        return follow(path, interval=max(0.1, args.interval),
                      max_frames=args.frames)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
