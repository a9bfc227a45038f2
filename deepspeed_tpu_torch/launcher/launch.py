"""The per-host launcher: one process per GPU of this host, supervised.

Counterpart of ``deepspeed_tpu/launcher/launch.py``. The JAX launcher runs
one process per host (a JAX process owns every local chip) and exports
``JAX_COORDINATOR_ADDRESS`` with a host-granular ``RANK``. Here, as in the
reference's ``deepspeed/launcher/launch.py``, each slot (GPU) of this host
gets a process of its own, whose environment (:func:`build_env`) holds:

* ``RANK``: the slots of the earlier hosts plus the local index;
* ``LOCAL_RANK``: the local index; ``WORLD_SIZE``: every host's slots;
* ``MASTER_ADDR``, ``MASTER_PORT``: the rendezvous of
  ``torch.distributed``, which ``comm.init_distributed`` reads;
* ``CUDA_VISIBLE_DEVICES``: this host's slots, so ``LOCAL_RANK`` indexes
  them (the JAX launcher's ``DS_TPU_CHIPS``).

Each child runs in a process group of its own; SIGINT and SIGTERM are
forwarded to every group. :func:`supervise` polls the children: when one
exits non-zero the others are killed (their NCCL peers would otherwise wait
in a collective forever) and the launcher exits with that first failure's
code. With ``--heartbeat_file`` it also kills every child once the file,
having existed, goes stale for ``--heartbeat_timeout`` seconds (exit 86,
counted as ``resilience/heartbeat_stale``); a file never created does not
trip it. The children find the file in ``DS_TPU_HEARTBEAT_FILE``, and an
engine with the ``watchdog`` block touches it every
``heartbeat_interval`` steps. Exit 87 is a child's graceful drain, as in
the JAX package: it kills no one.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import signal
import subprocess
import sys
import time
from typing import List

from deepspeed_tpu_torch.utils.logging import logger

# exit code of a supervisor kill (distinct from any child's own, so a
# restart policy can tell "wedged, killed by us" from "crashed")
HEARTBEAT_KILL_EXIT_CODE = 86
# exit code of a serving child that drained gracefully after SIGTERM
DRAIN_EXIT_CODE = 87


def parse_args(args=None):
    parser = argparse.ArgumentParser(description="per-host GPU launcher")
    parser.add_argument("--world_info", type=str, required=True,
                        help="base64 json {host: [GPU indices]}")
    parser.add_argument("--node_rank", type=int, default=0)
    parser.add_argument("--master_addr", type=str, default="127.0.0.1")
    parser.add_argument("--master_port", type=int, default=29500)
    parser.add_argument("--log_dir", type=str, default=None,
                        help="one log file per process (rank_<RANK>.log) instead of the "
                             "launcher's output")
    parser.add_argument("--heartbeat_file", type=str, default=None,
                        help="supervise this heartbeat file (exported to the children as "
                             "DS_TPU_HEARTBEAT_FILE)")
    parser.add_argument("--heartbeat_timeout", type=float, default=0.0,
                        help="seconds without a heartbeat touch before every child is "
                             "killed (0 = liveness polling only)")
    parser.add_argument("--poll_interval", type=float, default=2.0,
                        help="supervision poll cadence (s)")
    parser.add_argument("user_script", type=str)
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args=args)


def decode_world_info(encoded: str) -> dict:
    return json.loads(base64.urlsafe_b64decode(encoded.encode()).decode())


def host_slots(world_info: dict, node_rank: int) -> List[int]:
    """The GPU indices of host ``node_rank`` (``world_info``'s order)."""
    hosts = list(world_info)
    if not 0 <= node_rank < len(hosts):
        raise ValueError(f"node_rank {node_rank} out of range for {len(hosts)} nodes")
    return world_info[hosts[node_rank]]


def build_env(world_info: dict, node_rank: int, local_rank: int, master_addr: str,
              master_port: int, base_env=None) -> dict:
    """The environment of the process of slot ``local_rank`` on host
    ``node_rank``."""
    env = dict(base_env if base_env is not None else os.environ)
    hosts = list(world_info)
    slots = host_slots(world_info, node_rank)
    if not 0 <= local_rank < len(slots):
        raise ValueError(f"local_rank {local_rank} out of range for {len(slots)} slots")
    env["RANK"] = str(sum(len(world_info[h]) for h in hosts[:node_rank]) + local_rank)
    env["LOCAL_RANK"] = str(local_rank)
    env["WORLD_SIZE"] = str(sum(len(s) for s in world_info.values()))
    env["MASTER_ADDR"] = master_addr
    env["MASTER_PORT"] = str(master_port)
    env["CUDA_VISIBLE_DEVICES"] = ",".join(str(s) for s in slots)
    return env


def kill_process_tree(proc, grace_s: float = 10.0, sleep=time.sleep) -> None:
    """SIGTERM the child's process group, SIGKILL after ``grace_s`` if it
    did not die (a wedged process often ignores TERM)."""
    try:
        pgid = os.getpgid(proc.pid)
    except ProcessLookupError:
        return
    try:
        os.killpg(pgid, signal.SIGTERM)
    except ProcessLookupError:
        return
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            return
        sleep(0.1)
    try:
        os.killpg(pgid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _kill_all(procs, grace_s, sleep) -> None:
    for p in procs:
        if p.poll() is None:
            kill_process_tree(p, grace_s=grace_s, sleep=sleep)


def supervise(procs: List[subprocess.Popen], heartbeat_file=None,
              heartbeat_timeout: float = 0.0, poll_interval: float = 2.0,
              kill_grace: float = 10.0, clock=time.time, sleep=time.sleep):
    """Wait for every child, polling every ``poll_interval`` s. The first
    child to exit with a code other than 0 or ``DRAIN_EXIT_CODE`` gets the
    others killed, and its code is returned. With a heartbeat, a file that
    existed and then went stale past ``heartbeat_timeout`` kills every
    child (``HEARTBEAT_KILL_EXIT_CODE``). Returns ``(exit_code, reason)``:
    the first non-zero code in the order the children exited (0 when all
    succeeded) and "exited", "failed" or the heartbeat's reason."""
    first = 0
    while True:
        for i, p in enumerate(procs):
            rc = p.poll()
            if rc is None or rc == 0:
                continue
            if first == 0:
                first = rc
            if rc != DRAIN_EXIT_CODE:
                logger.error(f"launcher: process {i} exited with {rc}; killing the others")
                _kill_all(procs, kill_grace, sleep)
                return first, "failed"
        if all(p.poll() is not None for p in procs):
            return first, "exited"
        if heartbeat_file and heartbeat_timeout > 0:
            try:
                age = clock() - os.path.getmtime(heartbeat_file)
            except OSError:
                age = None      # not created yet: liveness polling only
            if age is not None and age > heartbeat_timeout:
                reason = (f"heartbeat stale: {heartbeat_file} last touched {age:.0f}s ago "
                          f"(> {heartbeat_timeout:.0f}s) — killing the wedged processes")
                logger.error(f"launcher: {reason}")
                from deepspeed_tpu_torch import telemetry

                telemetry.get_registry().counter("resilience/heartbeat_stale").inc()
                _kill_all(procs, kill_grace, sleep)
                return HEARTBEAT_KILL_EXIT_CODE, reason
        sleep(poll_interval)


def main(args=None):
    args = parse_args(args)
    world_info = decode_world_info(args.world_info)
    envs = [build_env(world_info, args.node_rank, i, args.master_addr, args.master_port)
            for i in range(len(host_slots(world_info, args.node_rank)))]
    if args.heartbeat_file:
        for env in envs:
            env["DS_TPU_HEARTBEAT_FILE"] = args.heartbeat_file
        try:
            # a leftover file of an earlier run is already stale: any file
            # present after this point was made by this run
            os.remove(args.heartbeat_file)
        except OSError:
            pass
    cmd = [sys.executable, "-u", args.user_script] + args.user_args
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)

    procs = []
    for env in envs:
        out = open(os.path.join(args.log_dir, f"rank_{env['RANK']}.log"), "ab") \
            if args.log_dir else None
        logger.info(f"launching rank {env['RANK']}/{env['WORLD_SIZE']} "
                    f"(local {env['LOCAL_RANK']}): {cmd}")
        procs.append(subprocess.Popen(cmd, env=env, stdout=out,
                                      stderr=subprocess.STDOUT if out else None,
                                      start_new_session=True))
        if out is not None:
            out.close()

    def forward(sig, _frame):
        for p in procs:
            try:
                os.killpg(os.getpgid(p.pid), sig)
            except ProcessLookupError:
                pass

    signal.signal(signal.SIGINT, forward)
    signal.signal(signal.SIGTERM, forward)
    code, reason = supervise(procs, heartbeat_file=args.heartbeat_file,
                             heartbeat_timeout=args.heartbeat_timeout,
                             poll_interval=args.poll_interval)
    if reason not in ("exited", "failed"):
        logger.error(f"launcher: children terminated by the supervisor ({reason})")
    elif code == DRAIN_EXIT_CODE:
        logger.info(f"launcher: children exited via graceful drain (exit {DRAIN_EXIT_CODE})")
    sys.exit(code)


if __name__ == "__main__":
    main()
