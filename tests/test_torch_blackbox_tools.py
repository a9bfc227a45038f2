"""The port's small tools against the JAX package's, on the CPU.

``python -m deepspeed_tpu_torch.telemetry.cli`` (``ds_metrics``) prints
what ``bin/ds_metrics`` prints on the same ``metrics.jsonl`` (the table
with its blackbox, rewind and elasticity footer lines, ``--json``,
``--memory``, ``--serving``), and its ``--follow`` frame is the one-shot
view. ``python -m deepspeed_tpu_torch.elasticity.cli`` (``ds_elastic``)
prints JAX ``compute_elastic_config``'s schedule with ``-w`` and without
it. ``python -m deepspeed_tpu_torch.launcher.ssh`` (``ds_ssh``) without a
hostfile runs the command here and returns its code. ``python -m
deepspeed_tpu_torch.env_report`` (``ds_report``): its ``incident`` and
``goodput`` sections print what JAX's print, ``rewind`` reads the port's
checkpoint directory, the sections of modules not ported yet raise
``NotImplementedError`` naming their queue item, and the default view on a
machine without a card reports no device.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _metrics_records(seed=0):
    rng = np.random.RandomState(seed)
    recs = []
    for step in (5, 10):
        value = lambda: float(np.round(rng.rand() * 100, 4))  # noqa: E731
        recs += [
            {"name": "train/loss", "kind": "gauge", "value": value(), "step": step},
            {"name": "train/steps", "kind": "counter", "value": step, "step": step},
            {"name": "train/step_time_s", "kind": "histogram", "count": step, "p50": value(),
             "p90": value(), "p99": value(), "max": value(), "step": step},
            {"name": "blackbox/events", "kind": "counter", "value": step // 5,
             "labels": {"severity": "error"}, "step": step},
            {"name": "blackbox/events", "kind": "counter", "value": 3,
             "labels": {"severity": "warning"}, "step": step},
            {"name": "blackbox/ring_fill", "kind": "gauge", "value": 2.0 + step, "step": step},
            {"name": "blackbox/bundles", "kind": "counter", "value": 1,
             "labels": {"trigger": "watchdog_timeout"}, "step": step},
            {"name": "rewind/recoveries", "kind": "counter", "value": 1,
             "labels": {"tier": "ram"}, "step": step},
            {"name": "rewind/last_recovery_tier", "kind": "gauge", "value": 1.0, "step": step},
            {"name": "rewind/snapshots", "kind": "counter", "value": step, "step": step},
            {"name": "elasticity/restarts", "kind": "counter", "value": 1, "step": step},
            {"name": "profiling/live_bytes", "kind": "gauge", "value": value() * 1e6,
             "labels": {"bucket": "params"}, "step": step},
            {"name": "device/bytes_in_use", "kind": "gauge", "value": value() * 1e6,
             "step": step},
            {"name": "serving/admitted", "kind": "counter", "value": step, "step": step},
            {"name": "serving/completed", "kind": "counter", "value": step - 1, "step": step},
            {"name": "serving/shed", "kind": "counter", "value": 1,
             "labels": {"reason": "queue_full"}, "step": step},
            {"name": "serving/queue_depth", "kind": "gauge", "value": 1.0, "step": step},
            {"name": "serving/ttft_s", "kind": "histogram", "count": step, "p50": 0.1,
             "p90": 0.2, "p99": 0.3, "max": 0.4, "step": step},
        ]
    return recs


@pytest.fixture
def metrics_dir(tmp_path):
    d = tmp_path / "tel"
    d.mkdir()
    with open(d / "metrics.jsonl", "w") as f:
        for r in _metrics_records():
            f.write(json.dumps(r) + "\n")
        f.write('{"torn')
    return str(d)


@pytest.mark.parametrize("flags", [[], ["--json"], ["--memory"], ["--serving"],
                                   ["--memory", "--json"], ["--serving", "--json"]],
                         ids=lambda f: "-".join(f) or "table")
def test_ds_metrics_equals_bin_ds_metrics(metrics_dir, flags):
    from deepspeed_tpu_torch.telemetry import cli

    want = subprocess.run([sys.executable, os.path.join(REPO, "bin", "ds_metrics"),
                           metrics_dir, *flags], capture_output=True, text=True, timeout=60)
    assert want.returncode == 0, want.stderr
    rc, got = _run(cli.main, [metrics_dir, *flags])
    assert rc == 0 and got == want.stdout
    if not flags:
        assert "incident:" in got and "BUNDLES 1 (watchdog_timeout)" in got
        assert "rewind" in got.split("---")[-1]


def test_ds_metrics_follow_frame_and_errors(metrics_dir, capsys):
    from deepspeed_tpu_torch.telemetry import cli

    path = os.path.join(metrics_dir, "metrics.jsonl")
    frame = io.StringIO()
    assert cli.follow(path, interval=0.1, max_polls=1, out=frame) == 0
    _, once = _run(cli.main, [metrics_dir])
    assert frame.getvalue() == once
    for argv, rc in (([], 2), (["a", "b"], 2), (["-h"], 0), ([metrics_dir, "--interval"], 2),
                     ([metrics_dir, "--interval", "x"], 2),
                     ([os.path.join(metrics_dir, "none.jsonl")], 1)):
        want = subprocess.run([sys.executable, os.path.join(REPO, "bin", "ds_metrics"), *argv],
                              capture_output=True, text=True, timeout=60)
        assert _run(cli.main, list(argv))[0] == want.returncode == rc, argv


@pytest.mark.parametrize("world", [0, 8, 12])
def test_ds_elastic_equals_jax(tmp_path, world):
    from deepspeed_tpu.elasticity import compute_elastic_config
    from deepspeed_tpu_torch.elasticity import cli

    cfg = {"elasticity": {"enabled": True, "max_train_batch_size": 2000,
                          "micro_batch_sizes": [2, 4, 6], "min_gpus": 1, "max_gpus": 64,
                          "version": 0.1}}
    path = str(tmp_path / "ds_config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    rc, out = _run(cli.main, ["-c", path] + (["-w", str(world)] if world else []))
    assert rc == 0
    got = json.loads(out)
    want = compute_elastic_config(path, world_size=world)
    assert got["train_batch_size"] == want[0] and got["valid_chip_counts"] == list(want[1])
    if world:
        assert got["micro_batch"] == want[2] and got["world_size"] == world
    else:
        assert set(got) == {"train_batch_size", "valid_chip_counts"}


def test_ds_ssh_runs_locally_without_hostfile(tmp_path):
    from deepspeed_tpu_torch.launcher import ssh

    missing = str(tmp_path / "hostfile")
    rc, out = _run(ssh.main, ["-f", missing, "true"])
    assert rc == 0 and "running locally only" in out and "----- localhost (rc=0)" in out
    rc, out = _run(ssh.main, ["-f", missing, "false"])
    assert rc == 1 and "----- localhost (rc=1)" in out
    with open(missing, "w") as f:
        f.write("localhost slots=1\n")
    rc, out = _run(ssh.main, ["-f", missing, "echo", "hello"])
    assert rc == 0 and "hello" in out and "running locally only" not in out


def test_env_report_incident_delegates_to_incident(tmp_path):
    from deepspeed_tpu import env_report as jreport
    from deepspeed_tpu_torch import env_report as treport
    from deepspeed_tpu_torch.blackbox import incident

    d = tmp_path / "incidents" / "a_r0"
    d.mkdir(parents=True)
    (d / "manifest.json").write_text(json.dumps({
        "schema_version": 1, "trigger": "test", "rank": 0, "ts": 1000.0,
        "clock_anchor": {"epoch_s": 1000.0, "monotonic_s": 0.0}}))
    (d / "events.jsonl").write_text(json.dumps({
        "schema_version": 1, "event_id": "e1", "ts": 1000.0, "mono": 0.0, "step": 3,
        "rank": 0, "kind": "gray_verdict", "severity": "error",
        "payload": {"device": 3, "kind": "slow-compute"}}) + "\n")
    got = _run(treport.main, ["incident", str(tmp_path)])
    assert got == _run(jreport.main, ["incident", str(tmp_path)])
    assert got == _run(incident.main, ["report", str(tmp_path)])
    assert got[0] == 0 and "first cause: rank 0 device 3" in got[1]
    assert _run(treport.main, ["incident", "list", str(tmp_path)])[0] == 0


def test_env_report_goodput_equals_jax(tmp_path):
    from deepspeed_tpu import env_report as jreport
    from deepspeed_tpu_torch import env_report as treport
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.runtime.config import TelemetryConfig

    tel = str(tmp_path / "tel")
    telemetry.configure(TelemetryConfig(enabled=True, output_dir=tel, prometheus=False))
    try:
        tracer = telemetry.get_tracer()
        for step in range(3):
            with tracer.span("train_batch", step=step):
                with tracer.span("data", step=step):
                    pass
        telemetry.flush()
    finally:
        telemetry.deconfigure()
    got, want = _run(treport.main, ["goodput", tel]), _run(jreport.main, ["goodput", tel])
    assert got == want and got[0] == 0
    assert _run(treport.main, ["goodput"])[0] == 2


def test_env_report_rewind_reads_port_checkpoints(tmp_path):
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import env_report
    from deepspeed_tpu_torch.models import simple
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import wait_for_pending_saves

    model = simple.SimpleModel(16, 2).init_params(torch.Generator().manual_seed(0))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, device="cpu", config={
        "train_batch_size": 8, "steps_per_print": 0,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}})
    engine.train_batch((np.ones((8, 16), np.float32), np.ones((8, 1), np.float32)))
    engine.save_checkpoint(str(tmp_path))
    wait_for_pending_saves()
    rc, out = _run(env_report.main, ["rewind", str(tmp_path)])
    assert rc == 0
    assert "global_step1" in out and "<- ladder picks" in out and "tier-2 checkpoint" in out
    assert "world 1" in out
    assert _run(env_report.main, ["rewind", str(tmp_path / "none")])[0] == 2


@pytest.mark.parametrize("section", ["wire", "mesh", "doctor", "race", "xray", "roofline",
                                     "overlap"])
def test_env_report_unported_sections_raise_naming_their_item(section):
    from deepspeed_tpu_torch import env_report

    item = "item 3" if section in ("wire", "overlap") else "item 2"
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1, {item}"):
        if section == "overlap":
            env_report.overlap_report()
        else:
            env_report.main([section])


def test_env_report_default_view_without_a_card():
    from deepspeed_tpu_torch import env_report

    rc, out = _run(env_report.main, [])
    assert rc == 0
    hw = dict(env_report.hardware_report())
    assert hw["backend"] == "cpu" and hw["devices"] == "no CUDA device"
    assert "device name" not in hw and "device count" not in hw
    soft = dict(env_report.software_report())
    assert list(soft) == ["torch", "numpy", "einops", "scipy", "deepspeed_tpu_torch"]
    assert "N/A on CUDA" in dict(env_report.profiling_report())["memory_analysis"]
    assert "nvcc" in dict(env_report.kernel_report())
    assert "no CUDA device" in out and soft["torch"] in out
    proc = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.env_report"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "deepspeed_tpu_torch environment report" in proc.stdout
