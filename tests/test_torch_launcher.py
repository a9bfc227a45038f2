"""The port's launcher against the JAX package's, and a launched gloo world.

The hostfile and ``--include``/``--exclude`` grammar (the cases of
``tests/unit/test_launcher.py``) goes through both packages' parsers: the
same pools, the same errors with the same messages. ``encode_world_info``
gives the same string, the resource pool the same hosts and slots, and the
ssh, pdsh and slurm commands are the JAX package's with the port's module
in them. Where the packages differ by design, the port is held to its own
contract: one process per GPU with ``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``MASTER_*`` and ``CUDA_VISIBLE_DEVICES`` per slot; no
silent CPU run without a card; ``gcloud`` and ``--elastic_training``
refused; the supervisor's heartbeat kill (86), its tolerance of a file
never created, and its kill of every other child when one fails (the first
failure's code). Last, the runner launches two gloo ranks that train a
2-layer GPT-2 at ZeRO stage 2 on the CPU, and their losses equal the same
two-rank run spawned in process (``tests/torch_world.py``, the world in
which ``tests/test_torch_zero.py`` holds the engine against the JAX one)
within 1e-6.

The JAX package's launcher end-to-end test is among the reference
failures, so it is not the oracle here. This module imports JAX only inside
its functions: the spawned ranks and the launched script import it.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.launcher import launch, multinode_runner, runner
from tests.torch_world import World

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOSTFILES = {
    "good": "# comment line\nworker-0 slots=4\nworker-1 slots=4   # trailing comment\n\n"
            "worker-2 slots=8\n",
    "malformed": "worker-0 slots=abc\n",
    "duplicate": "w slots=2\nw slots=4\n",
    "comments_only": "# nothing\n\n",
    "missing": None,
}
POOL = {"worker-0": 4, "worker-1": 4, "worker-2": 8}
FILTERS = [("", ""), ("worker-0@worker-2", ""), ("worker-1:0,2", ""), ("worker-2:0-3", ""),
           ("worker-1:0@worker-1:2", ""), ("", "worker-1"), ("", "worker-0:1,3"),
           ("", "worker-0:0-3"), ("worker-0", "worker-1"), ("nope", ""), ("", "nope"),
           ("worker-1:5", "")]
SMALL = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2, n_head=2, remat=False)
TRAIN_CONFIG = {"train_batch_size": 4, "steps_per_print": 0, "zero_optimization": {"stage": 2},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}}}
STEPS = 3


def _outcome(fn, *args):
    """(result as a list of items, or the exception's type and message)."""
    try:
        out = fn(*args)
    except Exception as e:          # compared, not swallowed
        return type(e).__name__, str(e)
    return "ok", list(out.items()) if isinstance(out, dict) else out


# --------------------------------------------------- the JAX package's grammar
@pytest.mark.parametrize("name", list(HOSTFILES))
def test_hostfile_parses_like_jax(tmp_path, name):
    from deepspeed_tpu.launcher import runner as jrunner

    path = tmp_path / "hostfile"
    if HOSTFILES[name] is not None:
        path.write_text(HOSTFILES[name])
    got, want = (_outcome(r.fetch_hostfile, str(path)) for r in (runner, jrunner))
    assert got == want
    if name == "good":
        assert got == ("ok", [("worker-0", 4), ("worker-1", 4), ("worker-2", 8)])


@pytest.mark.parametrize("include,exclude", FILTERS)
def test_include_exclude_like_jax(include, exclude):
    from deepspeed_tpu.launcher import runner as jrunner

    got, want = (_outcome(r.parse_inclusion_exclusion, POOL, include, exclude)
                 for r in (runner, jrunner))
    assert got == want


@pytest.mark.parametrize("flags", [[], ["--num_nodes", "2"], ["--num_gpus", "2"],
                                   ["--include", "worker-1:1-3@worker-2"],
                                   ["--exclude", "worker-0@worker-1@worker-2"]])
def test_resource_pool_and_world_info_like_jax(tmp_path, flags):
    from deepspeed_tpu.launcher import runner as jrunner

    path = tmp_path / "hostfile"
    path.write_text(HOSTFILES["good"])
    argv = ["--hostfile", str(path), *flags, "train.py"]
    got, want = (_outcome(lambda: r.build_resource_pool(r.parse_args(argv)))
                 for r in (runner, jrunner))
    assert got == want
    if got[0] == "ok":
        active = dict(got[1])
        assert runner.encode_world_info(active) == jrunner.encode_world_info(active)
        assert launch.decode_world_info(runner.encode_world_info(active)) == active


def test_multinode_commands_are_jax_with_the_ports_module(tmp_path):
    """ssh, pdsh and slurm build the JAX package's command, naming
    ``deepspeed_tpu_torch.launcher.launch``; the exports are a CUDA job's."""
    from deepspeed_tpu.launcher import multinode_runner as jmulti
    from deepspeed_tpu.launcher import runner as jrunner

    argv = ["--master_port", "29600", "--launcher_args", "-p 2222", "train.py",
            "--deepspeed_config", "ds.json"]
    active = {"worker-0": [0, 1], "worker-1": [0, 1]}
    env = {"PYTHONPATH": "/src"}
    for name in ("ssh", "pdsh", "slurm"):
        t = multinode_runner.get_runner(name, runner.parse_args(argv), active, "worker-0")
        j = jmulti.get_runner(name, jrunner.parse_args(argv), active, "worker-0")
        cmd = t.get_cmd(env, active)
        assert "deepspeed_tpu_torch.launcher.launch" in " ".join(cmd), name
        assert json.dumps(cmd) == json.dumps(j.get_cmd(env, active)).replace(
            "deepspeed_tpu", "deepspeed_tpu_torch"), name
        assert t.export_env(env) == j.export_env(env), name
    t = multinode_runner.get_runner("ssh", runner.parse_args(argv), active, "worker-0")
    assert t.exports({"PYTHONPATH": "/src", "NCCL_DEBUG": "INFO", "CUDA_HOME": "/cuda",
                      "XLA_FLAGS": "-x", "HOME": "/home/user"}) == \
        {"PYTHONPATH": "/src", "NCCL_DEBUG": "INFO", "CUDA_HOME": "/cuda"}
    assert multinode_runner.get_runner("local", runner.parse_args(argv), active,
                                       "w").name == "ssh"


def test_refusals(monkeypatch, tmp_path):
    argv = ["--hostfile", str(tmp_path / "none"), "train.py"]
    with pytest.raises(ValueError, match="Cloud-TPU"):
        multinode_runner.get_runner("gcloud", runner.parse_args(argv), {"h": [0]}, "h")
    # --elastic_training validates the script's config, as the JAX runner does
    from deepspeed_tpu_torch.elasticity import ElasticityError

    with pytest.raises(ElasticityError, match="--deepspeed_config"):
        runner.main(["--elastic_training", "--num_gpus", "1", *argv])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.build_resource_pool(runner.parse_args(argv))
    assert runner.build_resource_pool(runner.parse_args(["--num_gpus", "3", *argv])) == \
        {"localhost": [0, 1, 2]}


# ------------------------------------------------------ one process per GPU
def test_per_gpu_environment_over_two_hosts():
    """Two hosts of 4 slots, slot 1 of the second excluded: 7 ranks, each
    host's slots in CUDA_VISIBLE_DEVICES, LOCAL_RANK indexing them."""
    active = runner.parse_inclusion_exclusion({"a": 4, "b": 4}, "", "b:1")
    info = launch.decode_world_info(runner.encode_world_info(active))
    envs = [launch.build_env(info, node, local, "a", 29700, base_env={"KEEP": "1"})
            for node in (0, 1) for local in range(len(info[("a", "b")[node]]))]
    seen = [(e["RANK"], e["LOCAL_RANK"], e["WORLD_SIZE"], e["CUDA_VISIBLE_DEVICES"])
            for e in envs]
    assert seen == [("0", "0", "7", "0,1,2,3"), ("1", "1", "7", "0,1,2,3"),
                    ("2", "2", "7", "0,1,2,3"), ("3", "3", "7", "0,1,2,3"),
                    ("4", "0", "7", "0,2,3"), ("5", "1", "7", "0,2,3"), ("6", "2", "7", "0,2,3")]
    assert all(e["MASTER_ADDR"] == "a" and e["MASTER_PORT"] == "29700" and e["KEEP"] == "1"
               for e in envs)
    with pytest.raises(ValueError, match="node_rank 2"):
        launch.build_env(info, 2, 0, "a", 29700)
    with pytest.raises(ValueError, match="local_rank 3"):
        launch.build_env(info, 1, 3, "a", 29700)


# ------------------------------------------------------------- supervision
def _child(code: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code], start_new_session=True)


SLEEP = "import time; time.sleep(60)"


def test_stale_heartbeat_kills_with_86(tmp_path):
    hb = tmp_path / "hb"
    hb.write_text("")
    old = time.time() - 100
    os.utime(hb, (old, old))
    proc = _child(SLEEP)
    code, reason = launch.supervise([proc], heartbeat_file=str(hb), heartbeat_timeout=5,
                                    poll_interval=0.05, kill_grace=5)
    assert code == launch.HEARTBEAT_KILL_EXIT_CODE == 86 and reason.startswith("heartbeat stale")
    assert proc.poll() is not None


def test_heartbeat_never_created_does_not_trip(tmp_path):
    procs = [_child("import time; time.sleep(0.5)") for _ in range(2)]
    code, reason = launch.supervise(procs, heartbeat_file=str(tmp_path / "never"),
                                    heartbeat_timeout=0.01, poll_interval=0.05)
    assert (code, reason) == (0, "exited")


def test_one_failed_child_kills_the_others():
    t0 = time.monotonic()
    procs = [_child(SLEEP), _child("import sys, time; time.sleep(0.3); sys.exit(3)"),
             _child(SLEEP)]
    code, reason = launch.supervise(procs, poll_interval=0.05, kill_grace=5)
    assert (code, reason) == (3, "failed") and time.monotonic() - t0 < 30
    assert all(p.poll() is not None for p in procs)


def test_a_drained_child_kills_no_one():
    procs = [_child("import time; time.sleep(0.6)"),
             _child("import sys; sys.exit(87)")]
    code, reason = launch.supervise(procs, poll_interval=0.05)
    assert (code, reason) == (87, "exited") and procs[0].returncode == 0


def test_launch_exits_with_the_failed_rank_code(tmp_path):
    """launch.py over two slots: rank 1 fails with 5 while rank 0 sleeps;
    the launcher kills rank 0 and exits 5."""
    script = tmp_path / "fail.py"
    script.write_text(
        "import os, sys, time\n"
        f"open(os.path.join({str(tmp_path)!r}, 'pid' + os.environ['RANK']), 'w')"
        ".write(str(os.getpid()))\n"
        "if os.environ['RANK'] == '1':\n    time.sleep(0.5)\n    sys.exit(5)\n"
        "time.sleep(60)\n")
    info = runner.encode_world_info({"localhost": [0, 1]})
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
                          f"--world_info={info}", "--poll_interval=0.1", str(script)],
                         cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 5, out.stderr[-2000:]
    assert time.monotonic() - t0 < 45
    pid0 = int((tmp_path / "pid0").read_text())
    with pytest.raises(ProcessLookupError):
        os.kill(pid0, 0)


# ------------------------------------------------ a launched world, end to end
def _batch():
    return {"input_ids": torch.from_numpy(np.random.RandomState(4).randint(
        0, SMALL["vocab_size"], size=(4, 16)).astype(np.int64))}


def train_two_layers(rank, world, out_dir, params_path, config):
    """STEPS steps of the 2-layer fp32 model on the CPU over the world the
    process is in (the launcher's or the in-process spawn's)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2

    model = gpt2.GPT2Model(gpt2.GPT2Config(**SMALL, dtype=torch.float32))
    model.load_state_dict(torch.load(params_path), assign=True)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu")
    return {"losses": [float(engine.train_batch(_batch())) for _ in range(STEPS)],
            "world": deepspeed_tpu_torch.comm.get_world_size(),
            "rank": deepspeed_tpu_torch.comm.get_rank()}


LAUNCHED = """\
import argparse, os, sys, torch
import deepspeed_tpu_torch
from tests.test_torch_launcher import train_two_layers

parser = argparse.ArgumentParser()
deepspeed_tpu_torch.add_config_arguments(parser)
parser.add_argument("--params")
parser.add_argument("--out")
args = parser.parse_args()
out = train_two_layers(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), args.out,
                       args.params, args.deepspeed_config)
out["env"] = {k: os.environ[k] for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE",
                                        "CUDA_VISIBLE_DEVICES", "MASTER_ADDR")}
out["local_rank_arg"] = args.local_rank
torch.save(out, os.path.join(args.out, "launched%s.pt" % os.environ["RANK"]))
deepspeed_tpu_torch.comm.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_runner_launches_two_gloo_ranks_like_the_in_process_world(tmp_path):
    from deepspeed_tpu_torch.models import gpt2

    params = tmp_path / "params.pt"
    torch.save(gpt2.GPT2Model(gpt2.GPT2Config(**SMALL, dtype=torch.float32))
               .init_params(torch.Generator().manual_seed(7)).state_dict(), params)
    ds_config = tmp_path / "ds.json"
    ds_config.write_text(json.dumps(TRAIN_CONFIG))
    script = tmp_path / "launched.py"
    script.write_text(LAUNCHED)
    spawned = World(train_two_layers, 2, str(tmp_path / "world"),
                    args=(str(params), TRAIN_CONFIG))
    out = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner", "--hostfile",
         str(tmp_path / "no_hostfile"), "--num_gpus", "2", "--master_port", str(_free_port()),
         str(script), "--deepspeed_config", str(ds_config), "--params", str(params),
         "--out", str(tmp_path)],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, capture_output=True, text=True,
        timeout=180)
    ref = spawned.join()
    assert out.returncode == 0, out.stderr[-3000:]
    for rank in range(2):
        got = torch.load(tmp_path / f"launched{rank}.pt")
        assert got["env"] == {"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": "2",
                              "CUDA_VISIBLE_DEVICES": "0,1", "MASTER_ADDR": "localhost"}
        assert (got["rank"], got["world"], got["local_rank_arg"]) == (rank, 2, -1)
        np.testing.assert_allclose(got["losses"], ref[rank]["losses"], rtol=1e-6)
    assert ref[0]["losses"][-1] < ref[0]["losses"][0]
