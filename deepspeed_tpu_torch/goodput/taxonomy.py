"""The closed badput taxonomy: bucket names and span classification.

Counterpart of ``deepspeed_tpu/goodput/taxonomy.py``, with its buckets in
its priority order. Every wall-second of a job goes to exactly one bucket:
where spans overlap, the higher-priority bucket takes the time (a second
inside both a compile span and the enclosing ``train_batch`` span is
compile, not compute), so per-step and job ledgers sum to their measured
window exactly, by construction.

Buckets, highest priority first:

``watchdog_stall``  time in a step that ended in a watchdog expiry (the
                    stall span the watchdog stamps);
``compile``         building device code (``cat="compile"`` spans). On
                    CUDA the goodput meter's flag has ``op_builder``
                    stamp each ``nvcc`` build and library load, and the
                    decode loops each CUDA graph capture
                    (``goodput/recorder.py``);
``checkpoint``      save and load spans (``cat="checkpoint"``);
``audit``           silent-data-corruption replay audits (``cat="audit"``);
``probe``           fail-slow microprobes (``cat="probe"``);
``data_wait``       the engine's ``data`` span: the host input pipeline;
``straggler_wait``  inside a matched collective, the wait for the last
                    rank: from matched multi-rank timelines in a fleet
                    report, from the comm layer's ``cat="straggler"``
                    excess spans on one rank;
``exposed_comm``    comm spans no compute span covers (the interval math
                    of ``FleetTrace.exposed_comm_us``);
``compute``         the rest of the time the train-phase spans cover: the
                    goodput bucket;
``restart``         downtime between one rank's telemetry sessions (job
                    reports only; ``restart_log.jsonl`` names it);
``idle``            everything else in the window.

The spans are host spans. A CUDA launch returns before the device runs it,
so a step's device time lands in whichever host span next waits for the
card (the engine's loss read, a timed collective's synchronize, the next
step's first blocking copy); the ledger classifies host time, as the JAX
one does, and the device's own busy share is a profile's to measure.

Standard library only: the reports run far from any card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# priority order: earlier wins where spans overlap. `restart` and `idle`
# are computed residually (gaps), never from spans, so they close the
# partition.
BUCKETS = ("watchdog_stall", "compile", "checkpoint", "audit", "probe",
           "data_wait", "straggler_wait", "exposed_comm", "compute",
           "restart", "idle")

GOODPUT_BUCKETS = ("compute",)
BADPUT_BUCKETS = tuple(b for b in BUCKETS if b not in GOODPUT_BUCKETS)

# span categories / names -> bucket (everything span-classifiable; the
# residual buckets have no span class on purpose)
_CAT_BUCKET = {"stall": "watchdog_stall", "compile": "compile",
               "checkpoint": "checkpoint", "audit": "audit",
               "probe": "probe", "straggler": "straggler_wait"}

# compute evidence: host spans that mean "the step is running or
# dispatching device work". train_batch encloses fwd/bwd/step, but the
# classification unions intervals, so nesting never counts twice.
COMPUTE_SPANS = ("train_batch", "fwd", "bwd", "step")


def is_span(ev: dict) -> bool:
    return ev.get("ph") == "X" and "dur" in ev


def span_bucket(ev: dict) -> Optional[str]:
    """The bucket a single span event argues for, or None when the event
    carries no classification weight (metadata, instants, serving spans —
    those are request-scoped, not step-scoped)."""
    if not is_span(ev):
        return None
    if (ev.get("args") or {}).get("background"):
        # background-thread work (an asynchronous checkpoint commit)
        # overlaps the step by design: charging it as badput would expose
        # what it hides; the wall time under it is classified by what the
        # step itself is doing
        return None
    cat = str(ev.get("cat", ""))
    if cat in _CAT_BUCKET:
        return _CAT_BUCKET[cat]
    name = str(ev.get("name", ""))
    if name == "save_checkpoint" or name == "load_checkpoint":
        return "checkpoint"
    if name == "data":
        return "data_wait"
    if name == "watchdog_stall":
        return "watchdog_stall"
    if name == "compile":
        return "compile"
    if cat == "comm":
        return "exposed_comm"       # demoted to overlap-aware exposed time
    if name in COMPUTE_SPANS:
        return "compute"
    return None


def interval(ev: dict) -> Tuple[float, float]:
    return (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))


def bucket_intervals(events: List[dict]) -> Dict[str, List[Tuple[float, float]]]:
    """Raw (unmerged, overlapping) intervals per span-classifiable bucket."""
    out: Dict[str, List[Tuple[float, float]]] = {}
    for ev in events:
        b = span_bucket(ev)
        if b is not None:
            out.setdefault(b, []).append(interval(ev))
    return out
