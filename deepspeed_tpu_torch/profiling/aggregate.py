"""Fleet-wide trace aggregation: merge per-rank traces, find the straggler.

Counterpart of ``deepspeed_tpu/profiling/aggregate.py``, standard library
only, so ``python -m deepspeed_tpu_torch.profiling.cli merge`` runs on a box
with no card. Each rank's telemetry session writes its own Chrome-trace
JSON (``trace.json`` / ``trace.rank<N>.json``, ``telemetry/tracing.py``)
with a rank-stamped pid; this module turns a directory of them into one
fleet view:

* :class:`FleetTrace`: per-rank traces (Chrome JSON or JSONL, the rank from
  the ``process_name`` metadata or the file name) merged into one
  Perfetto-loadable timeline, one process lane per rank;
* clock alignment: each rank's tracer clock starts at its own
  ``perf_counter`` zero; a blocking collective ends at about the same real
  instant on every rank, so the median per-rank offset of matched
  collective end times re-bases every lane onto one clock;
* collective matching: the comm layer's ``cat="comm"`` spans carry ``(op,
  seq, group)`` (``comm/comm.py``), so the k-th ``all_reduce`` over a group
  on rank 0 matches the k-th on rank 1; a match's arrival skew says who
  came last and how long the rest waited;
* the critical path: per step, the longest chain of leaf spans (data, fwd,
  bwd, collectives, step) ordered by end <= start, across ranks once
  aligned; and the exposed communication, comm time no compute covers.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

_RANK_IN_NAME = re.compile(r"rank[ _.]?(\d+)", re.IGNORECASE)


# ------------------------------------------------------------------ loading
def load_trace_events(path: str, warnings: Optional[List[str]] = None,
                      meta_out: Optional[dict] = None
                      ) -> Tuple[List[dict], Optional[int]]:
    """Events and best-effort rank of one trace file: the one trace parser
    (``merge`` and the goodput loaders go through it, so the format
    heuristics cannot drift between analyses).

    Accepts the writer's Chrome JSON (``{"traceEvents": [...]}``), a bare
    event list, or JSONL (one event object per line). Rank comes from the
    ``process_name`` metadata ("... rank N"), else the filename, else the
    events' pid, else None (caller falls back to file order). A torn
    JSONL tail (a run killed mid-append) is skipped LOUDLY — appended to
    ``warnings`` when the caller passes a list — never a silent hole and
    never fatal to the rest of the file. ``meta_out``, when given, is
    updated with the file's ``metadata`` dict (clock anchor, dropped
    span count) plus ``torn_lines``: the skipped-line count.
    """
    with open(path) as f:
        text = f.read()
    bad = 0
    try:
        data = json.loads(text)
        if isinstance(data, dict):
            if "traceEvents" in data:
                events = data["traceEvents"]
                if meta_out is not None:
                    meta_out.update(data.get("metadata") or {})
            else:
                # a one-event JSONL (also valid JSON)
                events = [data]
        else:
            events = data
    except json.JSONDecodeError:
        # JSONL: every line is an object, so the whole file is not valid JSON
        events = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                bad += 1
        if bad and warnings is not None:
            warnings.append(f"{path}: skipped {bad} torn/malformed JSONL "
                            "line(s) — events after a kill mid-append are "
                            "incomplete")
    if meta_out is not None:
        meta_out["torn_lines"] = bad
    return events, rank_from_events(events, path)


def rank_from_events(events: List[dict], path: str) -> Optional[int]:
    """Best-effort rank of an already-parsed event list: the
    ``process_name`` metadata ("... rank N"), else the filename, else a
    unanimous event pid, else None. Shared with the goodput trace loader
    so the heuristics cannot drift (and the file is not parsed twice)."""
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            m = _RANK_IN_NAME.search(str((ev.get("args") or {}).get("name", "")))
            if m:
                return int(m.group(1))
    m = _RANK_IN_NAME.search(path.replace("\\", "/").rsplit("/", 1)[-1])
    if m:
        return int(m.group(1))
    pids = {ev.get("pid") for ev in events if ev.get("ph") != "M"}
    if len(pids) == 1:
        (only,) = pids
        if isinstance(only, int):
            return only
    return None


# ----------------------------------------------------------------- matching
class CollectiveMatch(NamedTuple):
    """One collective matched across ranks by its canonical identity."""
    op: str
    seq: int
    group: str
    arrivals: Dict[int, Tuple[float, float]]   # rank -> (aligned start us, dur us)

    @property
    def skew_us(self) -> float:
        starts = [ts for ts, _ in self.arrivals.values()]
        return max(starts) - min(starts)

    @property
    def straggler(self) -> int:
        return max(self.arrivals, key=lambda r: self.arrivals[r][0])

    @property
    def fleet_cost_us(self) -> float:
        """Total µs the rest of the fleet spent waiting for the straggler."""
        last = max(ts for ts, _ in self.arrivals.values())
        return sum(last - ts for ts, _ in self.arrivals.values())

    def describe(self) -> str:
        return f"{self.op}#{self.seq} over {self.group or 'world'}"


class StragglerRow(NamedTuple):
    rank: int
    op: str
    seq: int
    group: str
    skew_us: float
    fleet_cost_us: float


class CriticalPath(NamedTuple):
    step: Optional[int]
    total_us: float                               # sum of on-path span durations
    wall_us: float                                # window end - start
    segments: List[Tuple[int, str, float, float]]  # (rank, name, start us, dur us)


def _is_span(ev: dict) -> bool:
    return ev.get("ph") == "X" and "dur" in ev


def _collective_key(ev: dict) -> Optional[Tuple[str, int, str]]:
    args = ev.get("args") or {}
    if ev.get("cat") != "comm" or "seq" not in args:
        return None
    return (str(args.get("op", ev.get("name", ""))), int(args["seq"]),
            str(args.get("group", "")))


class FleetTrace:
    """Per-rank trace events + the fleet-level analyses over them."""

    def __init__(self):
        self.by_rank: Dict[int, List[dict]] = {}
        self.warnings: List[str] = []
        self._offsets: Optional[Dict[int, float]] = None
        self._aligned_cache: Optional[Dict[int, List[dict]]] = None
        self._dup_keys: Optional[Dict[int, set]] = None

    @classmethod
    def from_files(cls, paths: Sequence[str]) -> "FleetTrace":
        """Load one trace per rank. The same path listed twice (easy with
        overlapping globs) is deduplicated; two DIFFERENT files claiming
        the same rank is an error — silently relabelling one (a stale
        trace from a previous run, usually) would let its events 'match'
        the current run's collectives and fabricate stragglers. An empty
        or span-less file is SKIPPED with a warning, never turned into a
        phantom lane; torn JSONL tails are counted in ``warnings``."""
        ft = cls()
        taken: Dict[int, str] = {}
        pending = []
        seen_paths = set()
        for path in paths:
            real = os.path.realpath(path)
            if real in seen_paths:
                continue
            seen_paths.add(real)
            events, rank = load_trace_events(path, warnings=ft.warnings)
            if not any(ev.get("ph") != "M" for ev in events):
                ft.warnings.append(
                    f"{path}: empty trace (no events) — skipped; a dead "
                    "rank leaves a hole, not a silent empty lane")
                continue
            if rank is None:
                pending.append(events)
            elif rank in taken:
                raise ValueError(
                    f"both {taken[rank]!r} and {path!r} identify as rank "
                    f"{rank} — remove the stale trace (or rename one so the "
                    "rank is read from the filename)")
            else:
                taken[rank] = path
                ft.by_rank[rank] = events
        next_rank = 0
        for events in pending:
            while next_rank in taken:
                next_rank += 1
            taken[next_rank] = "<unranked input>"
            ft.by_rank[next_rank] = events
        ranks = sorted(ft.by_rank)
        if ranks:
            # rank 0 always exists in a real job — start the gap scan at
            # 0 so a dead rank 0 (trace never flushed) is warned about too
            missing = sorted(set(range(0, ranks[-1] + 1)) - set(ranks))
            if missing:
                ft.warnings.append(
                    "missing rank trace(s): "
                    + ", ".join(str(r) for r in missing)
                    + f" (have {ranks}) — stragglers/critical-path cover "
                    "only the ranks present")
        return ft

    def add_rank(self, rank: int, events: List[dict]) -> None:
        self.by_rank[int(rank)] = list(events)
        self._offsets = None
        self._aligned_cache = None
        self._dup_keys = None

    def _duplicate_keys(self) -> Dict[int, set]:
        """Per rank: the collective identities (op, seq, group) that appear
        more than once in its trace. The per-(op, group) seq counters
        restart with each telemetry session, so a rank that went through
        an elastic restart mid-trace issues the same identities again, and
        matching session 2's all_reduce#0 with session 1's on another rank
        would fabricate large skews. Duplicated identities are left out of
        the clock alignment and the straggler matching, with a warning."""
        if self._dup_keys is not None:
            return self._dup_keys
        out: Dict[int, set] = {}
        for rank, events in self.by_rank.items():
            seen = set()
            dups = set()
            for ev in events:
                key = _collective_key(ev)
                if key is None or not _is_span(ev):
                    continue
                if key in seen:
                    dups.add(key)
                else:
                    seen.add(key)
            if dups:
                out[rank] = dups
                msg = (f"rank {rank}: {len(dups)} collective identities "
                       "appear more than once in one trace — an elastic "
                       "restart mid-trace (per-session seq counters reset); "
                       "duplicated identities are excluded from clock "
                       "alignment and straggler matching")
                if msg not in self.warnings:
                    self.warnings.append(msg)
        self._dup_keys = out
        return out

    # ------------------------------------------------------- clock alignment
    def clock_offsets(self) -> Dict[int, float]:
        """Per-rank clock offset (us) estimated from matched collective
        end-times: a blocking collective releases every rank at ~the same
        real instant, so the median deviation of each rank's end-times from
        the per-match fleet mean is that rank's clock skew. Ranks with no
        matched collectives (or a single-rank trace) get offset 0."""
        if self._offsets is not None:
            return self._offsets
        dups = self._duplicate_keys()
        ends: Dict[Tuple[str, int, str], Dict[int, float]] = {}
        for rank, events in self.by_rank.items():
            skip = dups.get(rank, ())
            for ev in events:
                key = _collective_key(ev)
                if key is not None and _is_span(ev) and key not in skip:
                    ends.setdefault(key, {})[rank] = ev["ts"] + ev["dur"]
        deviations: Dict[int, List[float]] = {r: [] for r in self.by_rank}
        for per_rank in ends.values():
            if len(per_rank) < 2:
                continue
            mean = sum(per_rank.values()) / len(per_rank)
            for rank, end in per_rank.items():
                deviations[rank].append(end - mean)
        offsets = {}
        for rank, devs in deviations.items():
            if devs:
                devs.sort()
                offsets[rank] = devs[len(devs) // 2]
            else:
                offsets[rank] = 0.0
        self._offsets = offsets
        return offsets

    def _aligned(self, align: bool) -> Dict[int, List[dict]]:
        if not align:
            return self.by_rank
        # cached: exposed_comm_summary calls this once per step, and merge
        # follows with critical_path + to_chrome_trace — re-copying every
        # skewed rank's events each time would be O(steps × events)
        if self._aligned_cache is not None:
            return self._aligned_cache
        offsets = self.clock_offsets()
        out = {}
        for rank, events in self.by_rank.items():
            off = offsets.get(rank, 0.0)
            if off == 0.0:
                out[rank] = events
            else:
                out[rank] = [dict(ev, ts=ev["ts"] - off) if "ts" in ev else ev
                             for ev in events]
        self._aligned_cache = out
        return out

    # ------------------------------------------------------------ merged view
    def to_chrome_trace(self, align: bool = True) -> dict:
        """One Perfetto-loadable timeline, one process lane per rank."""
        merged = []
        for rank in sorted(self.by_rank):
            merged.append({"name": "process_name", "ph": "M", "pid": rank,
                           "tid": 0, "args": {"name": f"rank {rank}"}})
            merged.append({"name": "process_sort_index", "ph": "M", "pid": rank,
                           "tid": 0, "args": {"sort_index": rank}})
        for rank, events in sorted(self._aligned(align).items()):
            for ev in events:
                if ev.get("ph") == "M":
                    continue
                merged.append(dict(ev, pid=rank))
        offsets = self.clock_offsets() if align else {}
        return {"traceEvents": merged, "displayTimeUnit": "ms",
                "metadata": {"ranks": sorted(self.by_rank),
                             "clock_offsets_us": {str(r): o for r, o
                                                  in sorted(offsets.items())}}}

    # ------------------------------------------------------------ collectives
    def collective_matches(self, align: bool = True) -> List[CollectiveMatch]:
        """Cross-rank matches of comm span events by (op, seq, group),
        ordered by sequence. Matches present on fewer than two ranks are
        dropped (nothing to skew against)."""
        dups = self._duplicate_keys()
        table: Dict[Tuple[str, int, str], Dict[int, Tuple[float, float]]] = {}
        for rank, events in self._aligned(align).items():
            skip = dups.get(rank, ())
            for ev in events:
                key = _collective_key(ev)
                if key is not None and _is_span(ev) and key not in skip:
                    table.setdefault(key, {})[rank] = (float(ev["ts"]),
                                                      float(ev["dur"]))
        return [CollectiveMatch(op=op, seq=seq, group=group, arrivals=arr)
                for (op, seq, group), arr in sorted(table.items(),
                                                    key=lambda kv: kv[0][1])
                if len(arr) >= 2]

    def straggler_table(self, top_k: int = 10,
                        align: bool = True) -> List[StragglerRow]:
        """Top-K collectives by fleet cost: which rank arrived last, at
        which op, and how many µs the rest of the fleet waited."""
        rows = [StragglerRow(rank=m.straggler, op=m.op, seq=m.seq,
                             group=m.group, skew_us=m.skew_us,
                             fleet_cost_us=m.fleet_cost_us)
                for m in self.collective_matches(align=align)]
        rows.sort(key=lambda r: -r.fleet_cost_us)
        return rows[:max(1, int(top_k))]

    def rank_cost_summary(self, align: bool = True) -> Dict[int, float]:
        """Total fleet µs each rank cost as the straggler."""
        cost: Dict[int, float] = {r: 0.0 for r in self.by_rank}
        for m in self.collective_matches(align=align):
            cost[m.straggler] = cost.get(m.straggler, 0.0) + m.fleet_cost_us
        return cost

    # ---------------------------------------------------------- critical path
    def steps(self) -> List[int]:
        out = set()
        for events in self.by_rank.values():
            for ev in events:
                step = (ev.get("args") or {}).get("step")
                if isinstance(step, int):
                    out.add(step)
        return sorted(out)

    def _step_leaves(self, step: Optional[int], align: bool
                     ) -> Tuple[Optional[int], List[Tuple[int, dict]]]:
        """(resolved step, leaf spans of that step across ranks) — the
        span-selection both :meth:`critical_path` and
        :meth:`exposed_comm_us` run on.

        Spans belong to the step when their ``args.step`` matches, or (comm
        events, which carry no step) when they fall inside the step's
        ``train_batch`` window. Container spans — those fully enclosing
        another selected span on the same rank — are dropped so the
        analyses see the phases, not the envelope.
        """
        aligned = self._aligned(align)
        if step is None:
            steps = self.steps()
            if not steps:
                return None, []
            step = steps[-1]
        windows = []
        spans: List[Tuple[int, dict]] = []
        for rank, events in aligned.items():
            for ev in events:
                if not _is_span(ev):
                    continue
                args = ev.get("args") or {}
                if args.get("step") == step:
                    if ev.get("name") == "train_batch":
                        windows.append((ev["ts"], ev["ts"] + ev["dur"]))
                    spans.append((rank, ev))
        if windows:
            lo = min(w[0] for w in windows)
            hi = max(w[1] for w in windows)
            for rank, events in aligned.items():
                for ev in events:
                    if (_is_span(ev) and ev.get("cat") == "comm"
                            and (ev.get("args") or {}).get("step") is None
                            and lo <= ev["ts"] and ev["ts"] + ev["dur"] <= hi):
                        spans.append((rank, ev))
        if not spans:
            return step, []
        # leaves only: drop spans that fully contain another selected span
        # on the same rank (train_batch encloses data/fwd/bwd/step/comm)
        def contains(outer, inner):
            return (outer["ts"] <= inner["ts"] and
                    outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"] and
                    outer is not inner)

        leaves = [(r, ev) for r, ev in spans
                  if not any(r == r2 and contains(ev, ev2)
                             for r2, ev2 in spans)]
        if not leaves:
            leaves = spans
        return step, leaves

    def critical_path(self, step: Optional[int] = None, align: bool = True,
                      tolerance_us: float = 1.0) -> Optional[CriticalPath]:
        """Longest dependency chain of leaf spans in one step, across ranks.

        Dependency: A precedes B when A ends no later than ``tolerance_us``
        after B starts; the path maximizes on-path duration (classic DAG
        longest-path DP). Span selection: :meth:`_step_leaves`.
        """
        step, leaves = self._step_leaves(step, align)
        if not leaves:
            return None
        leaves = sorted(leaves,
                        key=lambda x: (x[1]["ts"], x[1]["ts"] + x[1]["dur"]))
        n = len(leaves)
        best = [float(ev["dur"]) for _, ev in leaves]
        prev = [-1] * n
        for j in range(n):
            for i in range(j):
                _, a = leaves[i]
                _, b = leaves[j]
                if a["ts"] + a["dur"] <= b["ts"] + tolerance_us:
                    cand = best[i] + float(b["dur"])
                    if cand > best[j]:
                        best[j] = cand
                        prev[j] = i
        end = max(range(n), key=lambda j: best[j])
        chain = []
        j = end
        while j != -1:
            rank, ev = leaves[j]
            chain.append((rank, str(ev.get("name", "")), float(ev["ts"]),
                          float(ev["dur"])))
            j = prev[j]
        chain.reverse()
        lo = min(ev["ts"] for _, ev in leaves)
        hi = max(ev["ts"] + ev["dur"] for _, ev in leaves)
        return CriticalPath(step=step, total_us=best[end], wall_us=hi - lo,
                            segments=chain)

    # ----------------------------------------------------------- exposed comm
    def exposed_comm_us(self, step: Optional[int] = None,
                        align: bool = True) -> Optional[float]:
        """EXPOSED communication µs in one step: wall time where at least
        one comm span is running and NO compute span is — i.e. the union
        of the step's comm leaf intervals minus the union of its non-comm
        leaf intervals, fleet-wide once clocks are aligned.

        Overlap work (a gather prefetched, a reduce-scatter under the
        backward) shrinks exactly this quantity while the per-op comm
        histograms stay the same. Returns None when the step has no leaf spans at all, 0.0 when it
        has spans but no comm (nothing exposed).
        """
        step, leaves = self._step_leaves(step, align)
        if not leaves:
            return None
        comm = _merge_intervals([(ev["ts"], ev["ts"] + ev["dur"])
                                 for _, ev in leaves
                                 if ev.get("cat") == "comm"])
        compute = _merge_intervals([(ev["ts"], ev["ts"] + ev["dur"])
                                    for _, ev in leaves
                                    if ev.get("cat") != "comm"])
        return _measure(_subtract_intervals(comm, compute))

    def exposed_comm_summary(self, align: bool = True) -> Dict[str, Any]:
        """Per-step exposed-comm µs and their average over the complete
        steps: the ``exposed_comm_us_per_step`` line ``merge`` prints."""
        per_step: Dict[int, float] = {}
        for step in self.steps():
            us = self.exposed_comm_us(step=step, align=align)
            if us is not None:
                per_step[step] = us
        avg = (sum(per_step.values()) / len(per_step)) if per_step else None
        return {"per_step": per_step, "avg_us_per_step": avg}


# ------------------------------------------------------- interval arithmetic
def _merge_intervals(ivs: List[Tuple[float, float]]
                     ) -> List[Tuple[float, float]]:
    """Union of half-open intervals, sorted and disjoint."""
    ivs = sorted((lo, hi) for lo, hi in ivs if hi > lo)
    out: List[Tuple[float, float]] = []
    for lo, hi in ivs:
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _subtract_intervals(a: List[Tuple[float, float]],
                        b: List[Tuple[float, float]]
                        ) -> List[Tuple[float, float]]:
    """A minus B; both inputs must be merged (sorted, disjoint)."""
    out: List[Tuple[float, float]] = []
    j = 0
    for lo, hi in a:
        cur = lo
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            blo, bhi = b[k]
            if blo > cur:
                out.append((cur, blo))
            cur = max(cur, bhi)
            if cur >= hi:
                break
            k += 1
        if cur < hi:
            out.append((cur, hi))
    return out


def _measure(ivs: List[Tuple[float, float]]) -> float:
    return sum(hi - lo for lo, hi in ivs)
