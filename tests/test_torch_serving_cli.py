"""The port's serving CLI and the repo's status tools over its files.

``python -m deepspeed_tpu_torch.serving.cli --smoke --device cpu`` runs the
whole pipeline and exits 0; the repo's own ``bin/ds_serve status`` and
``bin/ds_metrics --serving`` render the directory it wrote as they render
a JAX run's, and the port's ``status`` prints the same text. ``serve
--trace`` drains on SIGTERM and exits 87. Without ``--device cpu`` on a
machine with no card the CLI raises, and bad usage exits 2.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": REPO}
CLI = [sys.executable, "-m", "deepspeed_tpu_torch.serving.cli"]


@pytest.fixture(scope="module")
def smoke_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("smoke"))
    proc = subprocess.run(CLI + ["--smoke", "--device", "cpu", "--output_dir", out],
                          capture_output=True, text=True, env=ENV, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["smoke"] == "ok" and summary["capacity"] == 2
    return out


def test_smoke_writes_the_run_files(smoke_dir):
    for name in ("metrics.jsonl", "metrics.prom", "serving_status.json"):
        assert os.path.isfile(os.path.join(smoke_dir, name)), name
    with open(os.path.join(smoke_dir, "serving_status.json")) as f:
        status = json.load(f)
    assert status["state"] == "dead" and status["breaker"] == "closed"
    assert status["counts"]["completed"] == 2
    assert status["counts"]["shed{reason=queue_full}"] == 1


def test_repo_tools_render_the_port_run(smoke_dir):
    proc = subprocess.run([sys.executable, os.path.join(REPO, "bin", "ds_serve"), "status",
                           smoke_dir], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    for want in ("state: dead", "breaker: closed", "request lifecycle", "admitted",
                 "no-silent-drops ledger: admitted 2", "… OK"):
        assert want in proc.stdout, want
    metrics = subprocess.run([sys.executable, os.path.join(REPO, "bin", "ds_metrics"),
                              smoke_dir, "--serving"], capture_output=True, text=True,
                             timeout=60)
    assert metrics.returncode == 0, metrics.stderr
    for want in ("request lifecycle", "ttft_deadline_fraction", "decode_chunk_seconds"):
        assert want in metrics.stdout, want


def test_port_status_prints_the_repo_text(smoke_dir, tmp_path, capsys):
    from deepspeed_tpu_torch.serving.cli import main

    ref = subprocess.run([sys.executable, os.path.join(REPO, "bin", "ds_serve"), "status",
                          smoke_dir], capture_output=True, text=True, timeout=60)
    for path in (smoke_dir, os.path.join(smoke_dir, "metrics.jsonl")):
        assert main(["status", path]) == 0
        got = capsys.readouterr().out
        if path == smoke_dir:
            assert got == ref.stdout
        else:                       # a metrics.jsonl handed directly
            assert "state: dead" in got and "request lifecycle" in got
    assert main(["status", str(tmp_path)]) == 1
    assert "no serving_status.json" in capsys.readouterr().err


def test_usage_and_the_card_requirement(capsys):
    from deepspeed_tpu_torch.serving.cli import main

    assert main([]) == 2
    assert main(["status"]) == 2
    assert main(["--no-such-flag"]) == 2
    capsys.readouterr()
    # no card here, and no --device cpu: the CLI raises, it does not run on the CPU
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--smoke"])


def test_serve_trace_drains_on_sigterm_with_87(tmp_path):
    out = tmp_path / "run"
    trace = tmp_path / "trace.jsonl"
    # a trace longer than the test: requests arrive every 50 ms for 30 s
    trace.write_text("".join(json.dumps({"id": f"r{i}", "prompt_len": 6, "max_new_tokens": 8,
                                         "arrival_s": 0.05 * i}) + "\n" for i in range(600)))
    config = tmp_path / "ds.json"
    config.write_text(json.dumps({
        "serving": {"max_queue_depth": 4, "decode_tick_tokens": 4, "drain_grace_s": 1.0},
        "telemetry": {"enabled": True, "output_dir": str(out), "trace": False}}))
    # the output goes to files: a pipe nobody reads could fill and stall the server
    log_out, log_err = open(tmp_path / "out.txt", "w"), open(tmp_path / "err.txt", "w")
    proc = subprocess.Popen(CLI + ["serve", "--trace", str(trace), "--config", str(config),
                                   "--model", "gpt2-tiny", "--dtype", "float32",
                                   "--max_out_tokens", "64", "--device", "cpu"],
                            stdout=log_out, stderr=log_err, env=ENV, cwd=REPO)
    try:
        status = out / "serving_status.json"
        deadline = time.monotonic() + 120
        served = False
        while time.monotonic() < deadline and not served:
            time.sleep(0.1)
            if status.is_file():
                counts = json.loads(status.read_text())["counts"]
                served = counts.get("completed", 0) >= 1
        assert served, "the server never completed a request"
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log_out.close()
        log_err.close()
    stdout = (tmp_path / "out.txt").read_text()
    assert proc.returncode == 87, (tmp_path / "err.txt").read_text()[-2000:]
    lines = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    assert lines and all(d["status"] in ("completed", "partial", "shed", "failed")
                         for d in lines)
    final = json.loads(status.read_text())
    assert final["state"] == "dead" and final["drain_reason"] == "signal"
