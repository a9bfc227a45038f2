"""The port's elasticity package and the launcher's heartbeat supervision
against the JAX package's, on the CPU.

``compute_elastic_config`` gives JAX's batch, chip counts and micro-batch
over a grid of configs, and the same errors; ``--elastic_training``
validates the script's config as the JAX runner does. ``DSElasticAgent``
completes and checkpoints, stops on preemption with an ordinary checkpoint
when no ``rewind`` block is armed, restarts a hung step (the watchdog's
``WatchdogTimeout``) with a ``restart_log.jsonl`` record of JAX's fields,
and installs the SIGUSR1 stack dump. A CPU child of the port's launcher
that trains under the ``watchdog`` block (its heartbeat from
``DS_TPU_HEARTBEAT_FILE``) and then wedges is killed with exit 86, and the
supervisor counts ``resilience/heartbeat_stale``.
"""

import faulthandler
import itertools
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.models import simple as tsimple
from deepspeed_tpu_torch.resilience import chaos as tchaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN, LAYERS = 16, 2
CFG = {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
       "steps_per_print": 0}


@pytest.fixture(autouse=True)
def _clean():
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT, signal.SIGUSR1)}
    yield
    tchaos.uninstall_chaos()
    ttel.deconfigure()
    for s, h in handlers.items():
        signal.signal(s, h)


# -------------------------------------------------------- the batch math
GRID = list(itertools.product(
    (32, 100, 2000), ([2, 4, 6], [1, 3], [8]), ((1, 8), (2, 16), (1, 10000)), (0.1, 0.2),
    (True, False), (1, 2)))


@pytest.mark.parametrize("case", range(0, len(GRID), 4), ids=lambda i: f"grid{i}")
def test_compute_elastic_config_equals_jax(case):
    from deepspeed_tpu.elasticity import compute_elastic_config as jcompute
    from deepspeed_tpu.elasticity import ElasticityError as JError
    from deepspeed_tpu_torch.elasticity import compute_elastic_config as tcompute
    from deepspeed_tpu_torch.elasticity import ElasticityError as TError

    for maxb, micro, (lo, hi), version, prefer, per_node in GRID[case:case + 4]:
        block = {"enabled": True, "max_train_batch_size": maxb, "micro_batch_sizes": micro,
                 "min_gpus": lo, "max_gpus": hi, "version": version,
                 "prefer_larger_batch": prefer, "num_gpus_per_node": per_node}
        for kw in ({}, {"return_microbatch": True}, {"world_size": 2}, {"world_size": 3}):
            try:
                want = jcompute({"elasticity": dict(block)}, **kw)
            except JError as e:
                with pytest.raises(TError) as got:
                    tcompute({"elasticity": dict(block)}, **kw)
                assert str(got.value) == str(e)
                continue
            assert tcompute({"elasticity": dict(block)}, **kw) == want, (block, kw)


def test_elastic_config_errors_as_jax(tmp_path):
    from deepspeed_tpu_torch.elasticity import (ElasticityError, compute_elastic_config,
                                                validate_elastic_config_from_script_args)
    from deepspeed_tpu_torch.launcher import runner

    with pytest.raises(ElasticityError, match="no 'elasticity' block"):
        compute_elastic_config({})
    with pytest.raises(ElasticityError, match="enabled is false"):
        compute_elastic_config({"elasticity": {}})
    with pytest.raises(ElasticityError, match="conflict"):
        compute_elastic_config({"elasticity": {"enabled": True}, "train_batch_size": 8})
    cfg = tmp_path / "ds.json"
    cfg.write_text(json.dumps({"elasticity": {"enabled": True, "max_train_batch_size": 64}}))
    args = runner.parse_args(["--num_gpus", "1", "train.py", "--deepspeed_config", str(cfg)])
    validate_elastic_config_from_script_args(args)
    # the runner validates before it launches
    launched = []
    import deepspeed_tpu_torch.launcher.runner as rmod

    class Done(Exception):
        pass

    def run(cmd, env=None):
        launched.append(cmd)
        raise Done

    orig = rmod.subprocess.run
    rmod.subprocess.run = run
    try:
        with pytest.raises(Done):
            runner.main(["--elastic_training", "--num_gpus", "1", "train.py",
                         f"--deepspeed_config={cfg}"])
        cfg.write_text(json.dumps({"elasticity": {"enabled": True}, "train_batch_size": 8}))
        with pytest.raises(ElasticityError, match="conflict"):
            runner.main(["--elastic_training", "--num_gpus", "1", "train.py",
                         "--deepspeed_config", str(cfg)])
    finally:
        rmod.subprocess.run = orig
    assert len(launched) == 1


# ------------------------------------------------------------- the agent
def _engine(extra=None):
    model = tsimple.SimpleModel(HIDDEN, LAYERS).init_params(torch.Generator().manual_seed(0))
    return deepspeed_tpu_torch.initialize(model=model, config={**CFG, **(extra or {})},
                                          device="cpu")[0]


def _batches():
    rng = np.random.RandomState(0)
    x, y = rng.randn(8, HIDDEN).astype(np.float32), rng.randn(8, HIDDEN).astype(np.float32)
    while True:
        yield (x, y)


def test_agent_completes_checkpoints_and_resumes(tmp_path):
    from deepspeed_tpu_torch.elasticity import DSElasticAgent
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import wait_for_pending_saves

    save = str(tmp_path / "ckpt")
    agent = DSElasticAgent(_engine, save, checkpoint_interval=2, install_signal_handlers=False)
    out = agent.run(_batches, num_steps=5)
    wait_for_pending_saves()
    assert (out["status"], out["final_step"], out["restarts"]) == ("complete", 5, 0)
    assert {"global_step2", "global_step4", "global_step5"} <= set(os.listdir(save))
    again = DSElasticAgent(_engine, save, install_signal_handlers=False).run(_batches, 7)
    assert again["final_step"] == 7
    assert again["restart_log"][0]["tier"] == "disk"


def test_agent_stops_on_preemption_with_a_checkpoint(tmp_path):
    from deepspeed_tpu_torch.elasticity import DSElasticAgent

    save = str(tmp_path / "ckpt")
    agent = DSElasticAgent(_engine, save, checkpoint_interval=100, install_signal_handlers=True)
    assert signal.getsignal(signal.SIGTERM) == agent._on_preempt
    out = agent.run(_batches, num_steps=50,
                    step_callback=lambda step, loss: step == 2 and os.kill(os.getpid(),
                                                                           signal.SIGTERM))
    faulthandler.unregister(signal.SIGUSR1)
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import wait_for_pending_saves

    wait_for_pending_saves()
    assert out["status"] == "preempted" and out["final_step"] == 3 and agent.preempted
    assert "global_step3" in os.listdir(save)          # no rewind block: the ordinary tag


def test_hung_step_is_a_restartable_failure(tmp_path):
    """A watchdog timeout is a restartable failure: the agent restarts from
    the RAM tier, and the restart record (JAX's fields: the kill drill of
    tests/test_torch_rewind_drills.py holds them to the JAX agent's) lands
    in restart_log.jsonl."""
    from deepspeed_tpu_torch.elasticity import DSElasticAgent

    block = {"watchdog": {"enabled": True, "min_step_timeout": 1.0, "startup_timeout": 60.0},
             "rewind": {"ram_interval": 2, "keep": 1},
             "telemetry": {"enabled": True, "output_dir": str(tmp_path / "tel")}}
    tchaos.install_chaos(tchaos.ChaosInjector(hang_at={"train_step": [4]}, hang_s=30.0))
    t0 = time.monotonic()
    out = DSElasticAgent(lambda: _engine(block), str(tmp_path / "ckpt"), checkpoint_interval=100,
                         max_restarts=1, install_signal_handlers=False).run(_batches, 5)
    assert out["status"] == "complete" and time.monotonic() - t0 < 10
    assert out["restart_reasons"][0].startswith("WatchdogTimeout")
    with open(tmp_path / "tel" / "restart_log.jsonl") as f:
        rec = json.loads(f.readline())
    assert (rec["tier"], rec["snapshot_step"], rec["steps_lost"], rec["step"]) == ("ram", 2, 1, 3)
    assert {"restart", "error", "backoff_s", "ts", "restore_s", "event_id"} <= set(rec)


def test_sigusr1_dumps_stacks_without_stopping(tmp_path):
    from deepspeed_tpu_torch.elasticity import DSElasticAgent
    from deepspeed_tpu_torch.resilience import watchdog as twd

    dump = tmp_path / "stacks.txt"
    twd.set_default_dump_path(str(dump))
    try:
        DSElasticAgent(_engine, str(tmp_path), install_signal_handlers=True)
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 10
        while not (dump.exists() and "SIGUSR1" in dump.read_text()):
            assert time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        faulthandler.unregister(signal.SIGUSR1)
        twd.set_default_dump_path(None)


# ---------------------------------------------------- the launcher's heartbeat
CHILD = """\
import os, sys, time
import numpy as np, torch
sys.path.insert(0, {repo!r})
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import simple
model = simple.SimpleModel(16, 2).init_params(torch.Generator().manual_seed(0))
engine = deepspeed_tpu_torch.initialize(model=model, device="cpu", config={{
    "train_batch_size": 8, "optimizer": {{"type": "Adam", "params": {{"lr": 1e-3}}}},
    "steps_per_print": 0, "watchdog": {{"enabled": True}}}})[0]
x = np.ones((8, 16), np.float32)
for _ in range(3):
    engine.train_batch((x, x))
open({marker!r}, "w").write(str(os.path.getmtime(os.environ["DS_TPU_HEARTBEAT_FILE"])))
time.sleep(120)                       # wedged: the heartbeat goes stale
"""


def test_stale_heartbeat_of_a_launched_child_kills_it_with_86(tmp_path):
    from deepspeed_tpu_torch.launcher import launch, runner

    hb, marker = tmp_path / "heartbeat", tmp_path / "stepped"
    script = tmp_path / "child.py"
    script.write_text(CHILD.format(repo=REPO, marker=str(marker)))
    info = runner.encode_world_info({"localhost": [0]})
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
                          f"--world_info={info}", f"--heartbeat_file={hb}",
                          "--heartbeat_timeout=4", "--poll_interval=0.1", str(script)],
                         cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=90)
    assert out.returncode == launch.HEARTBEAT_KILL_EXIT_CODE == 86, out.stderr[-2000:]
    assert marker.exists(), "the child trained and touched its heartbeat first"
    assert time.monotonic() - t0 < 80 and "heartbeat stale" in out.stdout + out.stderr

    # the supervisor counts the kill
    ttel.configure(_telemetry_config(tmp_path))
    hb.write_text("")
    os.utime(hb, (time.time() - 100, time.time() - 100))
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"],
                            start_new_session=True)
    code, reason = launch.supervise([proc], heartbeat_file=str(hb), heartbeat_timeout=5.0,
                                    poll_interval=0.05, kill_grace=2.0)
    assert code == 86 and proc.poll() is not None
    snap = {r["name"]: r["value"] for r in ttel.get_registry().snapshot()}
    assert snap["resilience/heartbeat_stale"] == 1


def _telemetry_config(tmp_path):
    from deepspeed_tpu_torch.runtime.config import TelemetryConfig

    return TelemetryConfig(enabled=True, output_dir=str(tmp_path / "t"), trace=False)
