"""``python -m deepspeed_tpu_torch.profiling.cli``: fleet trace merge, the
goodput report and the memory report.

Counterpart of ``deepspeed_tpu/profiling/cli.py`` (``bin/ds_prof``), with
its subcommands, flags and exit codes:

* ``merge <trace.json|jsonl|DIR>... [-o merged.json] [--top K] [--step N]
  [--no-align] [--json]``: the per-rank telemetry traces merged into one
  Perfetto timeline with a lane per rank, the top-K straggler table (which
  rank, which collective, how many µs it cost the fleet), the step's
  critical path and the exposed communication per step;
* ``goodput <DIR|trace>... [--restart-log F] [--no-straggler] [--json]``:
  the job's goodput report, every wall-second of every session (rotated
  ``trace.session*`` files included) in the closed taxonomy, the gaps
  between sessions charged to ``restart`` through the clock anchors and
  ``restart_log.jsonl``;
* ``memory <metrics.jsonl | DIR>``: the ``profiling/*`` series a run's
  memory profiler exported.

It calls itself ``ds_prof`` in its usage and messages, as the JAX tool
does. Standard library only: no card, no process group.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from deepspeed_tpu_torch.profiling.aggregate import FleetTrace
from deepspeed_tpu_torch.profiling.report import (load_metrics_records, render_critical_path,
                                                  render_exposed_comm, render_memory_summary,
                                                  render_straggler_report)


def _cmd_merge(args) -> int:
    paths = []
    for p in args.traces:
        if os.path.isdir(p):
            # rotated session traces (trace.session<N>...) are left out: two
            # sessions of one rank would read as two claims of the rank (an
            # error) or match collectives across a restart; the sessions
            # together are the goodput report's job
            paths.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if f.startswith("trace") and ".session" not in f
                and (f.endswith(".json") or f.endswith(".jsonl"))))
        else:
            paths.append(p)
    if not paths:
        print("ds_prof merge: no trace files given", file=sys.stderr)
        return 2
    try:
        ft = FleetTrace.from_files(paths)
    except ValueError as e:                   # e.g. two files claim one rank
        print(f"ds_prof merge: {e}", file=sys.stderr)
        return 2
    if not ft.by_rank:
        print("ds_prof merge: no usable trace events in the given files",
              file=sys.stderr)
        for w in ft.warnings:
            print(f"ds_prof merge: warning: {w}", file=sys.stderr)
        return 2
    align = not args.no_align
    merged = ft.to_chrome_trace(align=align)
    if args.output:
        tmp = args.output + ".tmp"
        with open(tmp, "w") as f:
            json.dump(merged, f)
        os.replace(tmp, args.output)
    rows = ft.straggler_table(top_k=args.top, align=align)
    cp = ft.critical_path(step=args.step, align=align)
    if args.step is not None:
        exposed = {"per_step": {}, "avg_us_per_step": None}
        us = ft.exposed_comm_us(step=args.step, align=align)
        if us is not None:
            exposed = {"per_step": {args.step: us}, "avg_us_per_step": us}
    else:
        exposed = ft.exposed_comm_summary(align=align)
    # straggler/alignment analyses run above; collect their degradation
    # warnings too (duplicate collective identities are detected lazily)
    warnings = list(ft.warnings)
    if args.json:
        rank_cost = ft.rank_cost_summary(align=align)
        cost_total = sum(rank_cost.values())
        print(json.dumps({
            "ranks": sorted(ft.by_rank),
            "clock_offsets_us": ft.clock_offsets() if align else {},
            "stragglers": [r._asdict() for r in rows],
            "rank_cost_us": rank_cost,
            # each rank's fraction of the total fleet waiting time — the
            # per-rank blame number a gray-failure hunt sorts by (all
            # zeros when no cross-rank collective matches were found)
            "rank_cost_share": {r: (round(c / cost_total, 4)
                                    if cost_total > 0 else 0.0)
                                for r, c in rank_cost.items()},
            "critical_path": cp._asdict() if cp else None,
            "exposed_comm_us_per_step": exposed["avg_us_per_step"],
            "exposed_comm_us_by_step": exposed["per_step"],
            "warnings": warnings,
            "output": args.output,
        }, indent=2, default=str))
        for w in warnings:
            print(f"ds_prof merge: warning: {w}", file=sys.stderr)
        return 0
    nev = sum(len(e) for e in ft.by_rank.values())
    print(f"merged {len(ft.by_rank)} rank trace(s), {nev} events"
          + (f" -> {args.output}" if args.output else "")
          + " (open in https://ui.perfetto.dev)")
    if align:
        offs = ft.clock_offsets()
        if any(abs(o) > 1.0 for o in offs.values()):
            print("clock offsets (us): "
                  + ", ".join(f"rank {r}: {o:+.0f}" for r, o in sorted(offs.items())))
    print()
    print(render_straggler_report(rows, ft.rank_cost_summary(align=align),
                                  top_k=args.top))
    print()
    print(render_critical_path(cp))
    print()
    print(render_exposed_comm(exposed))
    for w in warnings:
        print(f"ds_prof merge: warning: {w}", file=sys.stderr)
    return 0


def _cmd_goodput(args) -> int:
    """Job-level goodput report: classify every wall-second of the given
    session traces (dirs expand to ALL their trace files, rotated
    ``trace.session*`` included — restarts are the point), charge
    inter-session gaps to the ``restart`` bucket annotated from
    ``restart_log.jsonl``, and print the fleet-seconds table."""
    from deepspeed_tpu_torch.goodput.report import (build_job_report, find_session_traces,
                                                    load_restart_log, render_goodput_report)

    paths = find_session_traces(args.paths)
    if not paths:
        print("ds_prof goodput: no trace files found", file=sys.stderr)
        return 2
    restart_log = (load_restart_log(args.restart_log, explicit=True)
                   if args.restart_log else load_restart_log(args.paths))
    report = build_job_report(paths, restart_log=restart_log,
                              straggler=not args.no_straggler)
    if args.json:
        slim = {k: v for k, v in report.items() if k != "per_rank"}
        slim["per_rank"] = {
            str(r): {"sessions": pr["sessions"], "wall_s": pr["wall_s"],
                     "buckets_us": pr["buckets_us"]}
            for r, pr in report["per_rank"].items()}
        print(json.dumps(slim, indent=2, default=str))
    else:
        print(render_goodput_report(
            report, source=", ".join(args.paths)))
    if not report["ranks"]:
        return 2
    return 0


def _cmd_memory(args) -> int:
    path = args.path
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.jsonl")
    if not os.path.isfile(path):
        print(f"ds_prof memory: no such file: {path}", file=sys.stderr)
        return 1
    records, bad = load_metrics_records(path)
    print(render_memory_summary(records, source=path))
    if bad:
        print(f"ds_prof memory: skipped {bad} malformed line(s)", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="ds_prof",
        description="fleet trace aggregation + HBM memory reports")
    sub = parser.add_subparsers(dest="cmd")
    m = sub.add_parser("merge", help="merge per-rank traces; straggler + "
                                     "critical-path report")
    m.add_argument("traces", nargs="+",
                   help="per-rank trace files (or a telemetry output dir)")
    m.add_argument("-o", "--output", default=None,
                   help="write the merged Perfetto JSON here")
    m.add_argument("--top", type=int, default=10,
                   help="straggler table size (default 10)")
    m.add_argument("--step", type=int, default=None,
                   help="critical-path step (default: last complete step)")
    m.add_argument("--no-align", action="store_true",
                   help="skip collective-based clock alignment")
    m.add_argument("--json", action="store_true",
                   help="machine-readable report instead of tables")
    mem = sub.add_parser("memory", help="summarize profiling/* memory series")
    mem.add_argument("path", help="metrics.jsonl or the telemetry output dir")
    gp = sub.add_parser("goodput",
                        help="job-level goodput/badput report across "
                             "sessions and elastic restarts")
    gp.add_argument("paths", nargs="+",
                    help="telemetry output dir(s) or session trace files "
                         "(dirs include rotated trace.session* files)")
    gp.add_argument("--restart-log", action="append", default=[],
                    help="explicit restart_log.jsonl path(s); default: "
                         "restart_log.jsonl found in the given dirs")
    gp.add_argument("--no-straggler", action="store_true",
                    help="skip the cross-rank straggler-wait attribution")
    gp.add_argument("--json", action="store_true",
                    help="machine-readable report instead of the table")
    args = parser.parse_args(argv)
    if args.cmd == "merge":
        return _cmd_merge(args)
    if args.cmd == "memory":
        return _cmd_memory(args)
    if args.cmd == "goodput":
        return _cmd_goodput(args)
    parser.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
