"""The job's goodput report across a restart, and the port's command-line
tools, against the JAX package.

The port's elastic agent trains a small GPT-2 under the ``telemetry`` and
``goodput`` blocks until a ``preempt`` chaos fault (SIGTERM to this
process at the third step) stops it with a checkpoint; after 1.5 s a
second agent resumes from the tag in a new telemetry session (the first
session's trace moved aside as ``trace.session1.json``), and its bring-up
appends the "resume from disk tier" record to ``restart_log.jsonl``. On
those files the port's ``build_job_report`` equals JAX's (every bucket,
session and restart record), charges the gap between the sessions to
``restart`` with the record's reason, and closes: its buckets sum to its
fleet seconds.

The CLIs on the same directory: ``python -m
deepspeed_tpu_torch.profiling.cli goodput|merge|memory`` print what
``bin/ds_prof``'s ``main`` prints (JSON and tables), and ``python -m
deepspeed_tpu_torch.goodput.top --once`` what ``bin/ds_top --once``
prints, up to the frame's "flushed N s ago"; an empty directory and a
missing subcommand give JAX's exit codes.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2, n_head=2, remat=False,
             use_flash_attention=False)
PREEMPT_AT, STEPS, DOWNTIME_S = 3, 6, 1.5


def _engine(tel_dir):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2 as tgpt2

    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32)).init_params(
        torch.Generator().manual_seed(0))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, device="cpu", config={
        "train_batch_size": 8, "steps_per_print": 0,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
        "telemetry": {"enabled": True, "output_dir": tel_dir, "flush_interval": 1},
        "goodput": {}})
    return engine


@pytest.fixture(scope="module")
def restarted(tmp_path_factory):
    """Two agent runs, preempted then resumed: the telemetry directory."""
    import faulthandler

    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.elasticity import DSElasticAgent
    from deepspeed_tpu_torch.resilience import chaos
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import wait_for_pending_saves

    root = tmp_path_factory.mktemp("restart")
    tel, save = str(root / "tel"), str(root / "ckpt")
    ids = np.random.RandomState(1).randint(0, SMALL["vocab_size"], size=(8, 32))
    batches = [{"input_ids": ids}] * STEPS
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT, signal.SIGUSR1)}
    outs = []
    try:
        chaos.install_chaos(chaos.ChaosInjector(preempt_at={"train_step": [PREEMPT_AT]}))
        outs.append(DSElasticAgent(lambda: _engine(tel), save, checkpoint_interval=100,
                                   install_signal_handlers=True).run(batches, STEPS))
        wait_for_pending_saves()
        chaos.uninstall_chaos()
        telemetry.flush()
        time.sleep(DOWNTIME_S)
        outs.append(DSElasticAgent(lambda: _engine(tel), save, checkpoint_interval=100,
                                   install_signal_handlers=False).run(batches, STEPS))
        wait_for_pending_saves()
    finally:
        faulthandler.unregister(signal.SIGUSR1)
        chaos.uninstall_chaos()
        telemetry.deconfigure()
        for s, h in handlers.items():
            signal.signal(s, h)
    return tel, outs


def test_the_drill_preempted_and_resumed(restarted):
    tel, outs = restarted
    assert [o["status"] for o in outs] == ["preempted", "complete"]
    assert sorted(f for f in os.listdir(tel) if f.startswith("trace")) == \
        ["trace.json", "trace.session1.json"]
    with open(os.path.join(tel, "restart_log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["error"] for r in records] == ["resume from disk tier"]


def test_job_report_charges_the_downtime_to_restart_as_jax_does(restarted):
    from deepspeed_tpu.goodput import report as jreport
    from deepspeed_tpu_torch.goodput import report as treport

    tel, _ = restarted
    paths = treport.find_session_traces([tel])
    assert paths == jreport.find_session_traces([tel])
    log = treport.load_restart_log([tel])
    assert log == jreport.load_restart_log([tel])
    got = treport.build_job_report(paths, restart_log=log)
    assert got == jreport.build_job_report(paths, restart_log=log)
    assert got["sessions"] == 2 and got["ranks"] == [0]
    assert got["buckets_s"]["restart"] >= DOWNTIME_S
    assert got["restarts"][0]["reasons"] == ["resume from disk tier"]
    assert got["restarts"][0]["recoveries"][0]["tier"] == "disk"
    assert sum(got["buckets_s"].values()) == pytest.approx(got["fleet_seconds"], rel=1e-12)
    assert treport.render_goodput_report(got, source=tel) == \
        jreport.render_goodput_report(got, source=tel)


def _cli(main, args, capsys):
    try:
        rc = main(list(args))
    except SystemExit as e:
        rc = e.code
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _port_module(module, *args):
    """The port's tool run as ``python -m module args``."""
    proc = subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, timeout=120, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO})
    return proc.returncode, proc.stdout, proc.stderr


@pytest.mark.parametrize("args", [("goodput",), ("goodput", "--json"), ("merge",),
                                  ("merge", "--json"), ("memory",)])
def test_profiling_cli_prints_what_ds_prof_prints(restarted, args, capsys):
    from deepspeed_tpu.profiling import cli as jcli
    from deepspeed_tpu_torch.profiling import cli as tcli

    tel, _ = restarted
    argv = [args[0], tel, *args[1:]]
    got = _cli(tcli.main, argv, capsys)
    assert got == _cli(jcli.main, argv, capsys)
    assert got[0] == 0
    if args == ("goodput",):
        # the module's entry point prints the same
        assert _port_module("deepspeed_tpu_torch.profiling.cli", *argv) == got


def test_top_once_prints_what_ds_top_prints(restarted, capsys):
    from deepspeed_tpu.goodput import top as jtop
    from deepspeed_tpu_torch.goodput import top as ttop

    tel, _ = restarted
    age = lambda r: (r[0], re.sub(r"\(flushed \d+s ago\)", "(flushed Ns ago)", r[1]), r[2])
    got = age(_cli(ttop.main, [tel, "--once"], capsys))
    assert got == age(_cli(jtop.main, [tel, "--once"], capsys))
    assert got[0] == 0 and "goodput" in got[1] and "step 6" in got[1]
    assert age(_port_module("deepspeed_tpu_torch.goodput.top", tel, "--once")) == got


@pytest.mark.parametrize("args", [("goodput",), ("merge",), ("memory",), ()])
def test_empty_dirs_and_usage_errors_give_jax_exit_codes(tmp_path, args, capsys):
    from deepspeed_tpu.profiling import cli as jcli
    from deepspeed_tpu_torch.profiling import cli as tcli

    argv = [*args, str(tmp_path)] if args else []
    got = _cli(tcli.main, argv, capsys)
    assert got == _cli(jcli.main, argv, capsys)
    assert got[0] != 0


def test_top_usage_error_gives_jax_exit_code(capsys):
    from deepspeed_tpu.goodput import top as jtop
    from deepspeed_tpu_torch.goodput import top as ttop

    got = _cli(ttop.main, [], capsys)
    assert got == _cli(jtop.main, [], capsys)
    assert got[0] == 2
