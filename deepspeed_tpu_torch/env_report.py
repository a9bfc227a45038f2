"""The environment report (``ds_report``).

Counterpart of ``deepspeed_tpu/env_report.py`` (``bin/ds_report``). Run as
``python -m deepspeed_tpu_torch.env_report [incident|goodput|rewind ...]``.
The default view prints the software stack (torch, numpy, einops, scipy,
the port), the hardware (backend, world size, the card's name, free and
total memory, and its power limit from ``nvidia-smi``), the allocator's
memory, and the kernels' toolchain (``nvcc``, the libraries built into
``deepspeed_tpu_torch/build/``, the aio library). The sections:

  incident DIR...  the merged incident report (``blackbox/incident.py``)
  goodput DIR      the newest session's goodput buckets
  rewind SAVE_DIR  the restore ladder's view of a checkpoint directory

``wire``, ``mesh``, ``doctor``, ``race``, ``xray``, ``roofline`` and the
overlap rows read modules that are not ported yet (``analysis/``,
``sharding/``, the wire and overlap engines): each raises
``NotImplementedError`` naming its item of ROADMAP.md's Queue 1.
"""

from __future__ import annotations

import functools
import importlib
import os
import shutil
import subprocess
import sys
from typing import List, Optional, Tuple

GREEN_OK = "\033[92m[OKAY]\033[0m"
RED_NO = "\033[91m[NO]\033[0m"
NO_DEVICE = "no CUDA device"

# the sections that wait for a later slice: section -> what it needs
LATER_SECTIONS = {
    "wire": "the wire engine (ROADMAP.md Queue 1, item 3)",
    "overlap": "the overlap engine (ROADMAP.md Queue 1, item 3)",
    "mesh": "sharding/ (ROADMAP.md Queue 1, item 2)",
    "doctor": "analysis/ (ROADMAP.md Queue 1, item 2)",
    "race": "analysis/ (ROADMAP.md Queue 1, item 2)",
    "xray": "analysis/ (ROADMAP.md Queue 1, item 2)",
    "roofline": "analysis/ (ROADMAP.md Queue 1, item 2)",
}

Rows = List[Tuple[str, object]]


def _version(mod_name: str):
    try:
        return getattr(importlib.import_module(mod_name), "__version__", "unknown")
    except Exception:  # noqa: BLE001
        return None


def software_report() -> Rows:
    rows: Rows = [(mod, _version(mod) or RED_NO)
                  for mod in ("torch", "numpy", "einops", "scipy")]
    rows.append(("deepspeed_tpu_torch", _version("deepspeed_tpu_torch") or RED_NO))
    return rows


@functools.lru_cache(maxsize=None)
def nvidia_smi_line() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, or
    None without the tool (read once per process)."""
    if shutil.which("nvidia-smi") is None:
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def hardware_report() -> Rows:
    """The backend, world size and, on CUDA, the card: its name, free and
    total memory (``cudaMemGetInfo``) and power limit. On a machine
    without a card it says so and reports no device."""
    import torch

    rows: Rows = []
    try:
        on_card = torch.cuda.is_available()
        rows.append(("backend", "cuda" if on_card else "cpu"))
        rows.append(("world size", _world_size()))
        if not on_card:
            rows.append(("devices", NO_DEVICE))
            return rows
        rows.append(("device count", torch.cuda.device_count()))
        rows.append(("device name", torch.cuda.get_device_name(0)))
        free, total = torch.cuda.mem_get_info(0)
        rows.append(("memory per device", f"{total / 2**30:.1f} GiB "
                                          f"({free / 2**30:.2f} free)"))
        rows.append(("CUDA (torch build)", torch.version.cuda))
        rows.append(("nvidia-smi name, power limit", nvidia_smi_line() or RED_NO))
    except Exception as e:  # noqa: BLE001
        rows.append(("cuda devices", f"{RED_NO} ({e})"))
    return rows


def profiling_report() -> Rows:
    """The caching allocator's bytes in use and peak per card; the JAX
    row of XLA's ``memory_analysis`` has no CUDA counterpart."""
    import torch

    rows: Rows = []
    if not torch.cuda.is_available():
        rows.append(("accelerator memory", NO_DEVICE))
    else:
        n = torch.cuda.device_count()
        for i in range(n):
            stats = torch.cuda.memory_stats(i)
            use = stats.get("allocated_bytes.all.current", 0)
            peak = stats.get("allocated_bytes.all.peak", 0)
            total = torch.cuda.get_device_properties(i).total_memory
            rows.append((f"device {i} memory", f"{use / 2**30:.2f} / {total / 2**30:.2f} GiB "
                                               f"in use (peak {peak / 2**30:.2f})"))
            if i == 0 and n > 4:
                rows.append(("...", f"({n} local devices)"))
                break
    rows.append(("memory_analysis", "N/A on CUDA: the step runs eagerly, and no compiled "
                                    "program's buffers can be read before it runs "
                                    "(profiling/memory.py executable_memory)"))
    return rows


def overlap_report() -> Rows:
    raise NotImplementedError(f"ds_report overlap: needs {LATER_SECTIONS['overlap']}")


def kernel_report() -> Rows:
    """``nvcc``, the libraries built so far, the aio library and the host
    toolchain."""
    from deepspeed_tpu_torch.ops import op_builder

    rows: Rows = []
    try:
        rows.append(("nvcc", op_builder._nvcc()))
    except RuntimeError:
        rows.append(("nvcc", RED_NO))
    built = sorted(p.name for p in op_builder.BUILD_DIR.glob("*.so")) \
        if op_builder.BUILD_DIR.is_dir() else []
    rows.append(("built libraries", ", ".join(built) if built else "none yet (built at "
                                                                   "first use)"))
    try:
        from deepspeed_tpu_torch.ops import aio

        rows.append(("async_io (C++)", GREEN_OK if aio.LIBRARY.library_path.exists()
                     else "not built yet (g++ at first use)"))
    except Exception as e:  # noqa: BLE001
        rows.append(("async_io (C++)", f"{RED_NO} ({e})"))
    for tool in ("g++", "ninja"):
        rows.append((tool, GREEN_OK if shutil.which(tool) else RED_NO))
    return rows


def _tag_world(tag_dir: str) -> Optional[int]:
    """The device count a tag was saved under (its ``client_state.json``
    world signature), or None."""
    import json

    try:
        with open(os.path.join(tag_dir, "client_state.json")) as f:
            return int(json.load(f)["world"]["device_count"])
    except (OSError, ValueError, TypeError, KeyError):
        return None


def rewind_section(args) -> int:
    """``rewind <save_dir>``: every candidate tag with its tier (emergency
    or ordinary), step, saved world and verification verdict, and the one
    the ladder would pick. The tier-0 RAM ring is process-local and not
    visible here."""
    from deepspeed_tpu_torch.resilience.manifest import (candidate_tags, read_latest,
                                                         tag_step, verify_tag)
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import is_emergency_tag

    if not args:
        print("usage: ds_report rewind <checkpoint save_dir>", file=sys.stderr)
        return 2
    save_dir = os.path.abspath(args[0])
    if not os.path.isdir(save_dir):
        print(f"ds_report rewind: no such directory: {save_dir}", file=sys.stderr)
        return 2
    tags = candidate_tags(save_dir)
    latest = read_latest(save_dir)
    print(f"restore ladder for {save_dir}")
    print("(tier-0 RAM snapshots are process-local: see the run's ds_top/"
          "ds_metrics rewind line)")
    if not tags:
        print("  no candidate tags")
        return 1
    picked = None
    for tag in tags:
        tag_dir = os.path.join(save_dir, tag)
        tier = "tier-1 emergency" if is_emergency_tag(tag_dir) else "tier-2 checkpoint"
        ok, reason = verify_tag(tag_dir)
        parsed = tag_step(tag)
        world = _tag_world(tag_dir)
        mark = ""
        if ok and picked is None:
            picked = tag
            mark = "  <- ladder picks"
        pointer = "  (= 'latest')" if tag == latest else ""
        print(f"  {tag:<28} {tier:<18} step {str(parsed) if parsed >= 0 else '?':<8} "
              f"world {str(world) if world else '?':<4} "
              f"{GREEN_OK if ok else RED_NO}{'' if ok else ' (' + reason + ')'}"
              f"{pointer}{mark}")
    if picked is None:
        print("  NOTHING restorable — every candidate failed verification")
        return 1
    return 0


def goodput_section(args) -> int:
    """``goodput <telemetry_dir | trace.json>``: the newest session trace's
    bucket table."""
    from deepspeed_tpu_torch.goodput.ledger import load_trace_file, session_ledger
    from deepspeed_tpu_torch.goodput.report import find_session_traces, render_session_table

    if not args:
        print("usage: ds_report goodput <telemetry_dir | trace.json>", file=sys.stderr)
        return 2
    paths = [p for p in find_session_traces(args) if os.path.isfile(p)]
    if not paths:
        print(f"ds_report goodput: no trace files under {args}", file=sys.stderr)
        return 2
    # rotation keeps history as trace.session<N>: the newest by mtime is live
    newest = max(paths, key=os.path.getmtime)
    led = session_ledger(load_trace_file(newest)["events"])
    if led is None:
        print(f"ds_report goodput: {newest} holds no spans", file=sys.stderr)
        return 2
    print(render_session_table(led, source=newest))
    return 0


def incident_section(args) -> int:
    """``incident <bundle_or_telemetry_dir>...``: the merged incident
    report; ``python -m deepspeed_tpu_torch.blackbox.incident`` is the full
    tool."""
    from deepspeed_tpu_torch.blackbox.incident import main as incident_main

    if not args or args[0].startswith("-") or os.path.exists(args[0]):
        args = ["report", *args]
    return incident_main(args)


def _print_rows(title: str, rows: Rows, width: int = 24) -> None:
    print(title)
    for k, v in rows:
        print(f"  {k:<{width}} {v}")


def main(args=None) -> int:
    args = list(sys.argv[1:] if args is None else args)
    sections = {"incident": incident_section, "goodput": goodput_section,
                "rewind": rewind_section}
    if args and args[0] in sections:
        return sections[args[0]](args[1:])
    if args and args[0] in LATER_SECTIONS:
        raise NotImplementedError(f"ds_report {args[0]}: needs {LATER_SECTIONS[args[0]]}")
    line = "-" * 72
    print(line)
    print("deepspeed_tpu_torch environment report")
    print(line)
    _print_rows("software:", software_report())
    print(line)
    _print_rows("hardware:", hardware_report(), width=30)
    print(line)
    _print_rows("profiling:", profiling_report())
    print(line)
    print(f"overlap: not ported, needs {LATER_SECTIONS['overlap']}")
    print(line)
    _print_rows("kernels/toolchain:", kernel_report())
    print(line)
    print(f"python: {sys.version.split()[0]}  "
          f"CUDA_VISIBLE_DEVICES: {os.environ.get('CUDA_VISIBLE_DEVICES', '')!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
