"""Run, drill and inspect the serving front-end.

Counterpart of ``deepspeed_tpu/serving/cli.py`` (``bin/ds_serve``), run as
``python -m deepspeed_tpu_torch.serving.cli``:

* ``--smoke [--device cpu] [--output_dir DIR]``: the whole pipeline (admit
  → prefill → chunked decode → structured shed → drain) on a tiny GPT-2
  with random weights, emitting the ``serving/*`` telemetry that
  ``bin/ds_metrics --serving`` renders; prints one JSON summary line.
* ``serve --trace FILE.jsonl --model PRESET [--config ds.json] [--device
  cpu]``: serve a request trace (one JSON object per line: ``{"id",
  "prompt" (ids) or "prompt_len", "max_new_tokens", "deadline_s",
  "arrival_s"}``) through a front-end with SIGTERM/SIGINT drain handlers;
  ``--model`` takes the port's registry presets (``models/registry.py``);
  prints one resolution JSON line per request.
* ``status DIR``: the health/SLO view of a run from its
  ``serving_status.json`` and ``metrics.jsonl`` (``profiling/report.py``),
  the text ``bin/ds_serve status`` prints.

The model runs on the card unless ``--device cpu`` is given; without a
card and without it, the CLI raises. Exit codes: 0 ok, 87
(``DRAIN_EXIT_CODE``) after a signal drain, 2 usage, 1 a failed smoke or
a status directory with nothing to show.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np


def _engine(model, dtype: str, max_out_tokens: int, device: Optional[str]):
    import deepspeed_tpu_torch

    return deepspeed_tpu_torch.init_inference(
        model, {"dtype": dtype, "max_out_tokens": max_out_tokens}, device=device)


def _tiny_engine(device: Optional[str], max_out_tokens: int = 64):
    """The JAX smoke's fixture: GPT-2, vocab 256, 2 layers of 64, fp32."""
    import torch

    from deepspeed_tpu_torch.accelerator import resolve_device
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    on_card = resolve_device(device).type == "cuda"
    cfg = GPT2Config(vocab_size=256, n_positions=128, n_embd=64, n_layer=2, n_head=4,
                     dtype=torch.float32, use_flash_decode=on_card)
    return _engine(GPT2Model(cfg), "float32", max_out_tokens, device)


def _preset_engine(preset: str, max_out_tokens: int, dtype: str, device: Optional[str]):
    """A registry preset in ``dtype``; on the card its decode step runs the
    decode kernel (``use_flash_decode``)."""
    from deepspeed_tpu_torch.accelerator import resolve_device
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.models.registry import resolve_family

    try:
        model_cls, presets = resolve_family(preset)
    except KeyError as e:
        raise SystemExit(f"ds_serve: unknown model preset {preset!r}: {e}")
    on_card = resolve_device(device).type == "cuda"
    torch_dtype = DeepSpeedInferenceConfig(dtype=dtype).torch_dtype()
    cfg = dataclasses.replace(presets[preset], dtype=torch_dtype, use_flash_decode=on_card)
    return _engine(model_cls(cfg), dtype, max_out_tokens, device)


def run_smoke(output_dir: Optional[str] = None, device: Optional[str] = None) -> int:
    """The admit → prefill → decode → shed → drain pipeline. Exit 0 iff
    every submitted request reached a terminal status and the telemetry
    landed."""
    import tempfile

    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.serving import ShedError, from_ds_config

    out = output_dir or tempfile.mkdtemp(prefix="ds_serve_smoke_")
    ds_cfg = DeepSpeedConfig({
        "serving": {"max_queue_depth": 2, "decode_tick_tokens": 4,
                    "decode_tick_timeout_s": 30.0, "breaker_threshold": 2,
                    "breaker_cooldown_s": 0.5, "drain_grace_s": 10.0},
        "telemetry": {"enabled": True, "output_dir": out,
                      "flush_interval": 10_000, "trace": False},
    })
    engine = _tiny_engine(device, max_out_tokens=64)
    fe = from_ds_config(engine, ds_cfg, start=False, status_dir=out)
    terminal, shed_at_admission = [], 0
    try:
        # fill the bounded queue while the worker is down...
        r1 = fe.submit(np.arange(8)[None, :] % 256, max_new_tokens=8, request_id="smoke-1")
        r2 = fe.submit(np.arange(8, 16)[None, :] % 256, max_new_tokens=8,
                       request_id="smoke-2")
        # ...the third sheds with a structured queue-full error
        try:
            fe.submit(np.arange(4)[None, :], max_new_tokens=4, request_id="smoke-3")
        except ShedError as e:
            shed_at_admission += 1
            assert e.reason == "queue_full", e.reason
        fe.start()
        terminal.append(r1.result(timeout=300))
        terminal.append(r2.result(timeout=300))
        # a hopeless deadline terminates deterministically too (shed at
        # admission on the service estimate, or resolved at its first tick)
        try:
            r4 = fe.submit(np.arange(4)[None, :], max_new_tokens=4, deadline_s=1e-4,
                           request_id="smoke-4")
            terminal.append(r4.result(timeout=300))
        except ShedError:
            shed_at_admission += 1
        fe.begin_drain("smoke")
        code = fe.drain(timeout=60)
    finally:
        fe.close()
        telemetry.flush()
        telemetry.deconfigure()
    ok = (all(r.done for r in terminal)
          and terminal[0].status == "completed"
          and terminal[1].status == "completed"
          and len(terminal[0].tokens) == 8
          and fe.state == "dead" and code == 0)
    summary = {"smoke": "ok" if ok else "FAILED",
               "telemetry_dir": out,
               "resolved": [r.to_dict() for r in terminal],
               "shed_at_admission": shed_at_admission,
               "capacity": fe.capacity,
               "counts": dict(fe.counts)}
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


def _load_trace(path: str):
    with open(path) as f:
        for n, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except ValueError:
                raise SystemExit(f"ds_serve: malformed trace line {n} in {path}")


def run_serve(args) -> int:
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.serving import ShedError, from_ds_config

    ds_cfg = DeepSpeedConfig(args.config if args.config else {"serving": {}})
    if not ds_cfg.serving_present:
        raise SystemExit("ds_serve: the ds_config has no 'serving' block; add one")
    engine = _preset_engine(args.model, args.max_out_tokens, args.dtype, args.device)
    fe = from_ds_config(engine, ds_cfg, start=False)
    if fe is None:
        raise SystemExit("ds_serve: the ds_config sets serving.enabled=false; flip it on "
                         "(or drop the key) to serve")
    # the handlers go in before the worker starts: the status file's
    # "ready" means a SIGTERM from now on drains
    fe.install_signal_handlers()
    fe.start()
    t0 = time.monotonic()
    pending = []
    rng = np.random.default_rng(0)
    vocab = engine.module.config.vocab_size
    for spec in _load_trace(args.trace):
        arrival = float(spec.get("arrival_s", 0.0))
        lag = t0 + arrival - time.monotonic()
        if lag > 0:
            time.sleep(lag)
        if fe.state in ("draining", "dead"):
            break
        prompt = spec.get("prompt")
        if prompt is None:
            n = int(spec.get("prompt_len", 8))
            prompt = rng.integers(0, min(255, vocab), size=(1, n)).tolist()
        try:
            req = fe.submit(np.asarray(prompt, np.int32),
                            max_new_tokens=int(spec.get("max_new_tokens", 32)),
                            deadline_s=spec.get("deadline_s"),
                            request_id=spec.get("id"))
            pending.append(req)
        except ShedError as e:
            print(json.dumps({"id": spec.get("id"), "status": "shed",
                              "reason": e.reason, "queue_depth": e.queue_depth,
                              "est_wait_s": e.est_wait_s,
                              "retry_after_s": e.retry_after_s}), flush=True)
    for req in pending:
        try:
            req.result(timeout=args.request_timeout)
        except TimeoutError:
            pass
    if fe.state not in ("draining", "dead"):
        fe.begin_drain("trace-complete")
    code = fe.drain(timeout=args.request_timeout)
    # resolutions print after the drain, which resolves everything still
    # in flight; anything unresolved (a tick wedged past every deadline)
    # is labelled, never passed off as a final state
    for req in pending:
        d = req.to_dict()
        if not req.done:
            d["status"] = "unresolved_at_exit"
        print(json.dumps(d), flush=True)
    telemetry.flush()
    return code


def run_status(path: str) -> int:
    """The status view of ``path`` (a run directory, its
    ``serving_status.json`` or its ``metrics.jsonl``), as ``bin/ds_serve
    status`` renders it."""
    from deepspeed_tpu_torch.profiling import report

    status = None
    if os.path.isdir(path):
        sfile = os.path.join(path, "serving_status.json")
        metrics = os.path.join(path, "metrics.jsonl")
    elif path.endswith(".jsonl"):
        sfile = os.path.join(os.path.dirname(path), "serving_status.json")
        metrics = path
    else:
        sfile = path
        metrics = os.path.join(os.path.dirname(path), "metrics.jsonl")
    if os.path.isfile(sfile):
        try:
            with open(sfile) as f:
                status = json.load(f)
        except ValueError:
            print(f"ds_serve: {sfile} is not a serving_status.json (invalid JSON)",
                  file=sys.stderr)
            return 2
    records = []
    if os.path.isfile(metrics):
        records, bad = report.load_metrics_records(metrics)
        if bad:
            print(f"ds_serve: skipped {bad} malformed metric line(s)", file=sys.stderr)
    if status is None and not records:
        print(f"ds_serve: no serving_status.json or metrics.jsonl under {path}",
              file=sys.stderr)
        return 1
    print(report.render_serving_summary(records, source=path, status=status))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "status":
        if len(argv) != 2:
            print(__doc__, file=sys.stderr)
            return 2
        return run_status(argv[1])
    p = argparse.ArgumentParser(prog="python -m deepspeed_tpu_torch.serving.cli",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--smoke", action="store_true", help="dry-run the whole serving pipeline")
    p.add_argument("--output_dir", default=None, help="telemetry/status dir for --smoke")
    p.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    sub = p.add_subparsers(dest="command")
    sv = sub.add_parser("serve", help="serve a request trace")
    sv.add_argument("--trace", required=True, help="request trace JSONL")
    sv.add_argument("--config", default=None, help="ds_config.json with a 'serving' block")
    sv.add_argument("--model", default="gpt2-tiny", help="model preset (models/registry.py)")
    sv.add_argument("--dtype", default="bfloat16")
    sv.add_argument("--max_out_tokens", type=int, default=1024)
    # SUPPRESS: a --device before "serve" is not overwritten by this default
    sv.add_argument("--device", default=argparse.SUPPRESS,
                    help="'cpu' to run on the CPU (default: the card)")
    sv.add_argument("--request_timeout", type=float, default=600.0,
                    help="client-side wait per pending request at trace end")
    try:
        args = p.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code else 0
    if args.smoke:
        return run_smoke(args.output_dir, args.device)
    if args.command == "serve":
        return run_serve(args)
    p.print_help(sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
