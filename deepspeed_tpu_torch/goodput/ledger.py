"""Per-step and per-session goodput ledgers over one rank's trace events.

Counterpart of ``deepspeed_tpu/goodput/ledger.py``. The classification is
interval arithmetic: each bucket claims the union of its spans' intervals,
buckets are assigned in :data:`~deepspeed_tpu_torch.goodput.taxonomy.BUCKETS`
priority order (a second two buckets claim goes to the higher one, once),
and what no span claims is ``idle``. The partition of the measured window
is disjoint and exhaustive, so::

    sum(buckets.values()) == window_width        # exactly, by construction

Standard library only (the interval helpers are ``profiling/aggregate.py``'s).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from deepspeed_tpu_torch.goodput.taxonomy import (BUCKETS, GOODPUT_BUCKETS,
                                            bucket_intervals, interval,
                                            is_span, span_bucket)
from deepspeed_tpu_torch.profiling.aggregate import (_merge_intervals, _measure,
                                               _subtract_intervals)

Interval = Tuple[float, float]


# ------------------------------------------------------------------ loading
def load_trace_file(path: str) -> Dict[str, Any]:
    """One session trace -> {events, rank, anchor_epoch_s, dropped_events,
    bad_lines, path}. Parsed by ``profiling.aggregate.load_trace_events``,
    the one trace parser: a torn JSONL tail is counted (``bad_lines``), not
    fatal, and the rank heuristics are ``merge``'s. The clock anchor
    (``metadata.clock_anchor``, the monotonic and epoch pair the tracer
    takes at its start) places sessions of different processes and
    restarts on one wall-time axis; ``anchor_epoch_s`` is None for a trace
    without one (the caller then says so rather than guess)."""
    from deepspeed_tpu_torch.profiling.aggregate import load_trace_events

    meta: Dict[str, Any] = {}
    events, rank = load_trace_events(path, meta_out=meta)
    if meta.get("rank") is not None:
        rank = meta["rank"]
    anchor = meta.get("clock_anchor") or {}
    epoch = anchor.get("epoch_s")
    return {"path": path, "events": list(events), "rank": rank,
            "anchor_epoch_s": float(epoch) if epoch is not None else None,
            "dropped_events": int(meta.get("dropped_events", 0) or 0),
            "bad_lines": int(meta.get("torn_lines", 0) or 0)}


# ------------------------------------------------------------ classification
def _clip(ivs: List[Interval], window: Interval) -> List[Interval]:
    lo, hi = window
    return [(max(a, lo), min(b, hi)) for a, b in ivs if b > lo and a < hi]


def _contains(outer: Interval, inner: Interval) -> bool:
    return outer[0] <= inner[0] and outer[1] >= inner[1] and outer != inner


def classify_window(events: List[dict], window: Interval,
                    straggler_intervals: Optional[List[Interval]] = None
                    ) -> Dict[str, float]:
    """Partition ``window`` (µs) into the taxonomy buckets using the spans
    in ``events``. ``straggler_intervals`` (fleet analyses only) claims
    the ``straggler_wait`` slot at its taxonomy priority. Returns µs per
    bucket; the values sum to the window width exactly.

    ``exposed_comm`` follows the same container-drop semantics as
    ``FleetTrace.exposed_comm_us``: a compute span that fully CONTAINS a
    comm span is an envelope around a blocking collective (the host was
    in the collective), not evidence of overlapped compute — only
    non-containing compute spans exonerate comm time. Comm time that a
    compute leaf does overlap is charged to ``compute`` (it was hidden)."""
    lo, hi = window
    width = max(0.0, hi - lo)
    out = {b: 0.0 for b in BUCKETS}
    if width <= 0:
        return out
    raw = bucket_intervals(events)
    if straggler_intervals:
        raw["straggler_wait"] = list(straggler_intervals)
    # containment is tested span-by-span (UNMERGED comm intervals), same
    # as FleetTrace._step_leaves — merging first would let a compute span
    # that envelopes one of two adjacent collectives dodge the drop
    comm_raw = raw.pop("exposed_comm", [])
    comm_ivs = _merge_intervals(_clip(comm_raw, window))
    compute_raw = [interval(ev) for ev in events
                   if is_span(ev) and span_bucket(ev) == "compute"]
    leaves = [c for c in compute_raw
              if not any(_contains(c, cm) for cm in comm_raw)]
    raw["exposed_comm"] = _subtract_intervals(
        comm_ivs, _merge_intervals(_clip(leaves, window)))
    claimed: List[Interval] = []
    for bucket in BUCKETS:
        if bucket in ("restart", "idle"):
            continue            # residual buckets — no span class
        ivs = _merge_intervals(_clip(raw.get(bucket, []), window))
        if bucket == "compute":
            # the hidden (leaf-overlapped) part of comm belongs here too
            ivs = _merge_intervals(ivs + _clip(comm_ivs, window))
        if not ivs:
            continue
        out[bucket] = _measure(_subtract_intervals(ivs, claimed))
        claimed = _merge_intervals(claimed + ivs)
    out["idle"] = width - _measure(claimed)
    return out


# ---------------------------------------------------------------- per step
def step_windows(events: List[dict]) -> List[Tuple[int, Interval]]:
    """Per-step measured windows: from the step's ``data`` span start (the
    host's wait for the batch belongs to the step it feeds) to its
    ``train_batch`` end. A step without a complete ``train_batch`` span is
    not listed: a half-recorded step would fabricate idle time."""
    tb: Dict[int, Interval] = {}
    data: Dict[int, float] = {}
    for ev in events:
        if not is_span(ev):
            continue
        step = (ev.get("args") or {}).get("step")
        if not isinstance(step, int):
            continue
        lo, hi = interval(ev)
        if ev.get("name") == "train_batch":
            cur = tb.get(step)
            tb[step] = (min(cur[0], lo), max(cur[1], hi)) if cur else (lo, hi)
        elif ev.get("name") == "data":
            data[step] = min(data.get(step, lo), lo)
    out = []
    for step in sorted(tb):
        lo, hi = tb[step]
        lo = min(lo, data.get(step, lo))
        out.append((step, (lo, hi)))
    return out


def step_ledgers(events: List[dict],
                 straggler_intervals: Optional[List[Interval]] = None
                 ) -> List[Dict[str, Any]]:
    """One ledger dict per complete step: ``{"step", "start_us",
    "wall_us", "buckets"}`` with ``sum(buckets) == wall_us`` exactly.

    Each window sees only the spans that can overlap it (a moving pointer
    over the start-sorted spans, pruned past each window), so a capped
    100k-event session of thousands of steps classifies in one pass."""
    spans = sorted((ev for ev in events if is_span(ev)),
                   key=lambda ev: ev["ts"])
    stragglers = sorted(straggler_intervals or [])
    out = []
    j = 0
    si = 0
    active: List[dict] = []
    active_s: List[Interval] = []
    # windows ascend in time in a normal run; a sentinel rewind repeats
    # step numbers, so order by window start (and sort the output by step)
    # to keep the moving pointer sound either way
    for step, window in sorted(step_windows(events), key=lambda sw: sw[1][0]):
        lo, hi = window
        while j < len(spans) and spans[j]["ts"] < hi:
            active.append(spans[j])
            j += 1
        active = [ev for ev in active if ev["ts"] + ev["dur"] > lo]
        while si < len(stragglers) and stragglers[si][0] < hi:
            active_s.append(stragglers[si])
            si += 1
        active_s = [iv for iv in active_s if iv[1] > lo]
        buckets = classify_window(active, window,
                                  straggler_intervals=active_s or None)
        out.append({"step": step, "start_us": lo,
                    "wall_us": hi - lo, "buckets": buckets})
    out.sort(key=lambda led: led["step"])
    return out


# ------------------------------------------------------------- per session
def session_ledger(events: List[dict],
                   straggler_intervals: Optional[List[Interval]] = None
                   ) -> Optional[Dict[str, Any]]:
    """Whole-session classification: the window is [first span start,
    last span end] and EVERY second in it lands in a bucket (inter-step
    gaps become ``idle`` unless a checkpoint/compile/stall span claims
    them). None when the trace holds no spans at all."""
    # background spans (asynchronous checkpoint commits) classify nothing
    # and must not set the session's extent: a commit thread outliving the
    # step loop would stretch the window into the restart gap (phantom idle
    # here, and a shorter gap the job report can no longer match restart
    # records against)
    spans = [ev for ev in events
             if is_span(ev) and not (ev.get("args") or {}).get("background")]
    if not spans:
        return None
    lo = min(interval(ev)[0] for ev in spans)
    hi = max(interval(ev)[1] for ev in spans)
    buckets = classify_window(events, (lo, hi),
                              straggler_intervals=straggler_intervals)
    return {"start_us": lo, "end_us": hi, "wall_us": hi - lo,
            "buckets": buckets,
            "steps": step_ledgers(events,
                                  straggler_intervals=straggler_intervals)}


# ------------------------------------------------------------------ helpers
def sum_buckets(dicts: List[Dict[str, float]]) -> Dict[str, float]:
    out = {b: 0.0 for b in BUCKETS}
    for d in dicts:
        for b, v in d.items():
            out[b] = out.get(b, 0.0) + float(v)
    return out


def goodput_fraction(buckets: Dict[str, float]) -> Optional[float]:
    total = sum(buckets.values())
    if total <= 0:
        return None
    return sum(buckets.get(b, 0.0) for b in GOODPUT_BUCKETS) / total


def top_badput(buckets: Dict[str, float]) -> Optional[Tuple[str, float]]:
    """(bucket, µs) of the largest non-goodput bucket, or None."""
    bad = [(b, v) for b, v in buckets.items()
           if b not in GOODPUT_BUCKETS and v > 0]
    if not bad:
        return None
    return max(bad, key=lambda kv: kv[1])
