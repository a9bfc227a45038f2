"""The incident bundle: an atomic ``incidents/<ts>_<trigger>/`` dump.

Counterpart of ``deepspeed_tpu/blackbox/bundle.py``. A bundle is what a
responder needs from one process, under a hard byte budget:

    manifest.json       trigger, rank, world size, clock anchor, config
                        fingerprint, schema version, truncation notes
    events.jsonl        the flight-recorder ring (envelope events)
    step_tail.jsonl     the recorder's rolling per-step samples
    metrics_tail.jsonl  the tail of the telemetry ``metrics.jsonl``
    trace_tail.jsonl    recent trace spans (live tracer, rotated sessions)
    restart_log.jsonl   the tail of the elastic agent's restart log
    env.json            the software and hardware rows of ``env_report``
                        and the environment variables that shape a run
    stacks.txt          faulthandler stacks and the named locks' holders

It is written into a ``.tmp`` sibling and moved into place with
``os.replace``, so a reader (or a crash during the dump) never sees half a
bundle.

``env.json``'s variables are the port's counterparts of the JAX list: the
JAX and TPU ones (``JAX_PLATFORMS``, ``XLA_FLAGS``, ``LIBTPU_INIT_ARGS``,
``TPU_CHIPS_PER_HOST_BOUNDS``, and the JAX bench's ``DS_BENCH_PRESET``)
give way to ``CUDA_VISIBLE_DEVICES``, ``PYTORCH_CUDA_ALLOC_CONF``,
``TORCH_CUDA_ARCH_LIST`` and every ``NCCL_*`` variable.
"""

from __future__ import annotations

import faulthandler
import json
import os
import shutil
import sys
import time
from typing import Any, Dict, List, Tuple

from deepspeed_tpu_torch import telemetry as _telemetry
from deepspeed_tpu_torch.telemetry.events import SCHEMA_VERSION
from deepspeed_tpu_torch.utils import locks as _locks
from deepspeed_tpu_torch.utils.logging import logger

# the shares of the byte budget each capped file gets; the manifest, env
# and stacks are small and uncapped, and the ring is bounded by ring_size
_TAIL_SHARES = {"metrics_tail.jsonl": 0.35, "trace_tail.jsonl": 0.45,
                "restart_log.jsonl": 0.20}

ENV_KEYS = ("CUDA_VISIBLE_DEVICES", "PYTORCH_CUDA_ALLOC_CONF", "TORCH_CUDA_ARCH_LIST")
ENV_PREFIXES = ("NCCL_",)


def _tail_lines(path: str, max_bytes: int) -> Tuple[List[str], bool]:
    """The last whole lines of ``path`` within ``max_bytes``, and whether
    the file was cut. A torn first line (the cut landed mid-record) is
    dropped."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            if size > max_bytes:
                f.seek(size - max_bytes)
            data = f.read(max_bytes)
    except OSError:
        return [], False
    truncated = size > max_bytes
    lines = data.decode("utf-8", errors="replace").splitlines()
    if truncated and lines:
        lines = lines[1:]
    return [ln for ln in lines if ln.strip()], truncated


def _write_jsonl(path: str, records: List[Dict[str, Any]]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for r in records:
            f.write(json.dumps(r, default=str) + "\n")


def _write_lines(path: str, lines: List[str]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def _collect_trace_tail(base_dir: str, span_tail: int, max_bytes: int,
                        notes: List[str]) -> List[Dict[str, Any]]:
    """Recent spans: the live tracer's, then each rotated session's. Each
    source starts with one ``_clock_anchor`` record, so the incident
    report can align ranks as ``profiling.cli merge`` does."""
    out: List[Dict[str, Any]] = []
    tracer = _telemetry.get_tracer()
    if getattr(tracer, "events", None) is not None:
        anchor = {"epoch_s": getattr(tracer, "epoch0", None),
                  "monotonic_s": getattr(tracer, "_t0", None)}
        out.append({"_clock_anchor": anchor, "_session": "live",
                    "rank": getattr(tracer, "pid", 0)})
        for ev in list(tracer.events)[-span_tail:]:
            out.append({**ev, "_session": "live"})
    try:
        names = sorted(n for n in os.listdir(base_dir)
                       if n.startswith("trace.session") and n.endswith(".json"))
    except OSError:
        names = []
    for name in names:
        path = os.path.join(base_dir, name)
        try:
            if os.path.getsize(path) > max(max_bytes, 1 << 23):
                notes.append(f"skipped oversized rotated trace {name}")
                continue
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            notes.append(f"unreadable rotated trace {name}: {e}")
            continue
        meta = doc.get("metadata", {}) if isinstance(doc, dict) else {}
        out.append({"_clock_anchor": meta.get("clock_anchor"), "_session": name,
                    "rank": meta.get("rank")})
        events = doc.get("traceEvents", []) if isinstance(doc, dict) else []
        for ev in events[-span_tail:]:
            out.append({**ev, "_session": name})
    return out


def _env_report() -> Dict[str, Any]:
    out: Dict[str, Any] = {"argv": list(sys.argv), "cwd": os.getcwd(), "pid": os.getpid()}
    try:
        from deepspeed_tpu_torch import env_report

        out["software"] = [[str(k), str(v)] for k, v in env_report.software_report()]
        out["hardware"] = [[str(k), str(v)] for k, v in env_report.hardware_report()]
    except Exception as e:  # noqa: BLE001
        out["error"] = str(e)
    out["env"] = {k: v for k, v in sorted(os.environ.items())
                  if k in ENV_KEYS or k.startswith(ENV_PREFIXES)}
    return out


def _write_stacks(path: str) -> None:
    # faulthandler writes to a raw file descriptor: it gets the real file
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"# blackbox stack dump pid={os.getpid()} ts={time.time():.3f}\n")
        f.flush()
        try:
            faulthandler.dump_traceback(file=f, all_threads=True)
        except Exception as e:  # noqa: BLE001
            f.write(f"(faulthandler failed: {e})\n")
        f.write("\n")
        try:
            f.write(_locks.format_lock_holders())
            f.write("\n")
        except Exception as e:  # noqa: BLE001
            f.write(f"(lock holders unavailable: {e})\n")


def _capped_trace_lines(base_dir: str, span_tail: int, cap: int,
                        notes: List[str]) -> List[str]:
    """The trace tail within ``cap`` bytes, newest kept; the anchor
    records are never dropped (alignment needs them)."""
    lines = [json.dumps(r, default=str)
             for r in _collect_trace_tail(base_dir, span_tail, cap, notes)]
    while lines and sum(len(ln) + 1 for ln in lines) > cap:
        for i, ln in enumerate(lines):
            if "_clock_anchor" not in ln:
                del lines[i]
                notes.append("trace_tail trimmed to byte budget")
                break
        else:
            break
    return lines


def write_bundle(recorder, trigger: str, base_dir: str) -> str:
    """Write one incident bundle under ``base_dir``/incidents; its path."""
    cfg = recorder.cfg
    budget = int(float(getattr(cfg, "max_bundle_mb", 16.0)) * (1 << 20))
    span_tail = int(getattr(cfg, "span_tail", 256))
    incidents = os.path.join(base_dir, "incidents")
    os.makedirs(incidents, exist_ok=True)
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    safe_trigger = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in str(trigger))[:48] or "event"
    name = f"{stamp}_{safe_trigger}"
    final = os.path.join(incidents, name)
    n = 1
    while os.path.exists(final):
        n += 1
        final = os.path.join(incidents, f"{name}.{n}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    notes: List[str] = []

    # each recorder read copies under the ring lock and releases it; no
    # lock is held across a file write
    events = recorder.ring_snapshot()
    _write_jsonl(os.path.join(tmp, "events.jsonl"), events)
    _write_jsonl(os.path.join(tmp, "step_tail.jsonl"), recorder.step_tail_snapshot())
    for fname, share in _TAIL_SHARES.items():
        cap = max(4096, int(budget * share))
        if fname == "trace_tail.jsonl":
            _write_lines(os.path.join(tmp, fname),
                         _capped_trace_lines(base_dir, span_tail, cap, notes))
            continue
        src = os.path.join(base_dir, "metrics.jsonl" if fname == "metrics_tail.jsonl"
                           else "restart_log.jsonl")
        lines, truncated = _tail_lines(src, cap)
        if truncated:
            notes.append(f"{fname}: source truncated to last {cap} bytes")
        _write_lines(os.path.join(tmp, fname), lines)
    with open(os.path.join(tmp, "env.json"), "w", encoding="utf-8") as f:
        json.dump(_env_report(), f, indent=1, default=str)
    _write_stacks(os.path.join(tmp, "stacks.txt"))

    manifest = {
        "schema_version": SCHEMA_VERSION,
        "trigger": str(trigger),
        "rank": recorder.rank,
        "world_size": recorder.world_size,
        "ts": recorder.now()["ts"],
        "clock_anchor": recorder.clock_anchor(),
        "config_fingerprint": recorder.config_fingerprint,
        "events_total": recorder.events_total,
        "errors_total": recorder.errors_total,
        "ring_len": len(events),
        "last_step": recorder.last_step,
        "budget_bytes": budget,
        "notes": notes,
        "files": sorted(os.listdir(tmp)) + ["manifest.json"],
    }
    manifest_path = os.path.join(tmp, "manifest.json")
    with open(manifest_path, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=1, default=str)

    # the budget's backstop: past it (pathological tails), empty the
    # largest capped file rather than exceed it
    total = sum(os.path.getsize(os.path.join(tmp, fn)) for fn in os.listdir(tmp))
    if total > budget:
        size = lambda fn: os.path.getsize(os.path.join(tmp, fn))  # noqa: E731
        for fn in sorted(_TAIL_SHARES, key=size, reverse=True):
            if total > budget:
                total -= size(fn)
                os.truncate(os.path.join(tmp, fn), 0)
                notes.append(f"{fn} emptied: bundle exceeded {budget} byte budget")
        with open(manifest_path, "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1, default=str)

    os.replace(tmp, final)
    return final


def prune_bundles(incidents_dir: str, max_bundles: int) -> None:
    """Delete the oldest bundles past ``max_bundles``, and stale ``.tmp``."""
    try:
        entries = sorted(e for e in os.listdir(incidents_dir)
                         if os.path.isdir(os.path.join(incidents_dir, e)))
    except OSError:
        return
    for e in [e for e in entries if e.endswith(".tmp")]:
        shutil.rmtree(os.path.join(incidents_dir, e), ignore_errors=True)
        entries.remove(e)
    for e in entries[:max(0, len(entries) - max(1, int(max_bundles)))]:
        logger.warning(f"blackbox: pruning old incident bundle {e}")
        shutil.rmtree(os.path.join(incidents_dir, e), ignore_errors=True)
