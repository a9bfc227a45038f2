"""The launcher's command line: resources, then one launch per host.

Counterpart of ``deepspeed_tpu/launcher/runner.py`` (and so of the
reference's ``deepspeed/launcher/runner.py``), with the same surface: a
``--hostfile`` of ``hostname slots=N`` lines, ``--include`` / ``--exclude``
filters (``host1@host2:0,2``, slot ranges ``0-3``), ``--num_nodes`` /
``--num_gpus``, and the same errors. A slot is a GPU, and the host's
``launch.py`` spawns one process per slot. Where it differs from the JAX
runner:

* without a hostfile the job is ``localhost`` with ``--num_gpus`` slots,
  else one per visible GPU (``torch.cuda.device_count()``); with neither
  it raises: no silent single-process CPU run;
* ``--elastic_training`` validates the ``elasticity`` block of the
  script's ``--deepspeed_config`` (``compute_elastic_config``) before
  launching, as the JAX runner does;
* the environment exported to other hosts is what a CUDA job needs
  (``EXPORT_ENVS``).

Run as ``python -m deepspeed_tpu_torch.launcher.runner [options] script.py
[script args]``.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import re
import shlex
import subprocess
import sys
from collections import OrderedDict
from typing import Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import logger

DLTS_HOSTFILE = "/job/hostfile"
# what other hosts' processes inherit: exact names, or prefixes ending in "_"
EXPORT_ENVS = ("PYTHONPATH", "NCCL_", "CUDA_", "TORCH_", "UCX_")
MASTER_PORT_DEFAULT = 29500
LAUNCH_MODULE = "deepspeed_tpu_torch.launcher.launch"


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        description="deepspeed_tpu_torch launcher: run a training script on GPUs of many hosts")
    parser.add_argument("-H", "--hostfile", type=str, default=DLTS_HOSTFILE,
                        help="hostfile with lines '<hostname> slots=<n_gpus>'")
    parser.add_argument("-i", "--include", type=str, default="",
                        help="subset of hosts/GPUs, e.g. 'host1@host2:0,2'")
    parser.add_argument("-e", "--exclude", type=str, default="",
                        help="hosts/GPUs to drop, same syntax as --include")
    parser.add_argument("--num_nodes", type=int, default=-1,
                        help="cap on number of hosts (first N of the hostfile)")
    parser.add_argument("--num_gpus", "--num_chips", dest="num_gpus", type=int, default=-1,
                        help="GPUs per host to use (one process each)")
    parser.add_argument("--master_addr", type=str, default=None,
                        help="rendezvous address; default = first host")
    parser.add_argument("--master_port", type=int, default=MASTER_PORT_DEFAULT,
                        help="rendezvous port of torch.distributed")
    parser.add_argument("--launcher", type=str, default="ssh",
                        choices=["ssh", "pdsh", "slurm", "gcloud", "local"],
                        help="multinode transport backend")
    parser.add_argument("--launcher_args", type=str, default="",
                        help="extra flags passed to the transport (e.g. ssh options)")
    parser.add_argument("--force_multi", action="store_true",
                        help="treat as multinode even with one host")
    parser.add_argument("--no_ssh_check", action="store_true",
                        help="skip host reachability probe")
    parser.add_argument("--elastic_training", action="store_true",
                        help="validate elastic config before launching")
    parser.add_argument("--enable_each_rank_log", type=str, default=None,
                        help="directory for per-process log files")
    parser.add_argument("user_script", type=str, help="training script to run")
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args=args)


def fetch_hostfile(hostfile_path: str) -> "OrderedDict[str, int]":
    """Parse ``hostname slots=N`` lines → ordered {host: slots}. Blank
    lines and ``#`` comments are skipped; duplicate hosts or malformed
    lines are errors; a missing file gives an empty pool."""
    if not os.path.isfile(hostfile_path):
        return OrderedDict()
    resource_pool: "OrderedDict[str, int]" = OrderedDict()
    with open(hostfile_path) as fd:
        for lineno, line in enumerate(fd, 1):
            line = line.split("#")[0].strip()
            if not line:
                continue
            m = re.match(r"^(\S+)\s+slots=(\d+)\s*$", line)
            if m is None:
                raise ValueError(f"{hostfile_path}:{lineno}: malformed line {line!r} "
                                 "(expected '<hostname> slots=<int>')")
            host, slots = m.group(1), int(m.group(2))
            if host in resource_pool:
                raise ValueError(f"{hostfile_path}:{lineno}: duplicate host {host!r}")
            resource_pool[host] = slots
    return resource_pool


def _parse_filter(spec: str) -> "OrderedDict[str, Optional[List[int]]]":
    """'host1@host2:0,2' → {host1: None, host2: [0, 2]} (None = all slots)."""
    out: "OrderedDict[str, Optional[List[int]]]" = OrderedDict()
    if not spec:
        return out
    for part in spec.split("@"):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            out[part] = None
            continue
        host, slot_str = part.split(":", 1)
        slots = []
        for tok in slot_str.split(","):
            tok = tok.strip()
            if "-" in tok:
                lo, hi = tok.split("-")
                slots.extend(range(int(lo), int(hi) + 1))
            else:
                slots.append(int(tok))
        if out.get(host) is not None:
            out[host].extend(s for s in slots if s not in out[host])
        else:
            out[host] = slots
    return out


def parse_inclusion_exclusion(resource_pool: Dict[str, int], inclusion: str,
                              exclusion: str) -> "OrderedDict[str, List[int]]":
    """Apply --include / --exclude to the hostfile pool → ordered {host:
    [GPU indices]}. A host left with no slot is dropped."""
    active: "OrderedDict[str, List[int]]" = OrderedDict(
        (host, list(range(slots))) for host, slots in resource_pool.items())
    inc = _parse_filter(inclusion)
    exc = _parse_filter(exclusion)
    if inc and exc:
        raise ValueError("--include and --exclude are mutually exclusive")

    if inc:
        picked: "OrderedDict[str, List[int]]" = OrderedDict()
        for host, slots in inc.items():
            if host not in active:
                raise ValueError(f"--include host {host!r} not in hostfile")
            avail = active[host]
            use = avail if slots is None else slots
            bad = [s for s in use if s not in avail]
            if bad:
                raise ValueError(f"--include slots {bad} not available on {host}")
            picked[host] = sorted(use)
        return picked

    for host, slots in exc.items():
        if host not in active:
            raise ValueError(f"--exclude host {host!r} not in hostfile")
        remaining = [] if slots is None else [s for s in active[host] if s not in slots]
        if remaining:
            active[host] = remaining
        else:
            del active[host]
    return active


def _local_gpu_count() -> int:
    """The GPUs this host shows; raises without one (the launcher never
    turns a missing card into a CPU run: ask with --num_gpus)."""
    import torch

    n = torch.cuda.device_count()
    if n < 1:
        raise RuntimeError("no CUDA device on this host and no --num_gpus or hostfile: "
                           "the launcher starts one process per GPU")
    return n


def build_resource_pool(args) -> "OrderedDict[str, List[int]]":
    """hostfile + filters + --num_nodes/--num_gpus → final {host: GPUs}."""
    pool = fetch_hostfile(args.hostfile)
    if not pool:
        n = args.num_gpus if args.num_gpus > 0 else _local_gpu_count()
        return OrderedDict([("localhost", list(range(n)))])
    active = parse_inclusion_exclusion(pool, args.include, args.exclude)
    if args.num_nodes > 0:
        active = OrderedDict(list(active.items())[:args.num_nodes])
    if args.num_gpus > 0:
        active = OrderedDict((h, gpus[:args.num_gpus]) for h, gpus in active.items())
    if not active:
        raise ValueError("no hosts left after filtering")
    return active


def _ssh_reachable(host: str) -> bool:
    if host in ("localhost", "127.0.0.1"):
        return True
    try:
        r = subprocess.run(["ssh", "-o", "PasswordAuthentication=no",
                            "-o", "ConnectTimeout=5", host, "hostname"],
                           capture_output=True, timeout=15)
        return r.returncode == 0
    except (subprocess.TimeoutExpired, FileNotFoundError):
        return False


def encode_world_info(active: "OrderedDict[str, List[int]]") -> str:
    """The world description passed to launch.py: {host: [GPU indices]} as
    urlsafe base64 of its JSON (the reference's encoded world_info)."""
    return base64.urlsafe_b64encode(json.dumps(active).encode()).decode()


def launch_cmd(active, master_addr: str, master_port: int, node_rank, user_script: str,
               user_args: List[str], log_dir: Optional[str] = None) -> List[str]:
    """``python -m deepspeed_tpu_torch.launcher.launch`` for one host."""
    cmd = [sys.executable, "-m", LAUNCH_MODULE, f"--world_info={encode_world_info(active)}",
           f"--master_addr={master_addr}", f"--master_port={master_port}",
           f"--node_rank={node_rank}"]
    if log_dir:
        cmd.append(f"--log_dir={log_dir}")
    return cmd + [user_script] + list(user_args)


def main(args=None):
    args = parse_args(args)
    active = build_resource_pool(args)
    hosts = list(active)
    multi_node = args.force_multi or len(hosts) > 1

    if args.elastic_training:
        from deepspeed_tpu_torch.elasticity import validate_elastic_config_from_script_args

        validate_elastic_config_from_script_args(args)

    if multi_node and not args.no_ssh_check and args.launcher in ("ssh", "pdsh"):
        unreachable = [h for h in hosts if not _ssh_reachable(h)]
        if unreachable:
            raise RuntimeError(f"hosts unreachable over ssh: {unreachable}")

    master_addr = args.master_addr or hosts[0]
    env = os.environ.copy()

    if not multi_node:
        # one host: its launch.py runs here, as a child
        cmd = launch_cmd(active, master_addr, args.master_port, 0, args.user_script,
                         args.user_args, args.enable_each_rank_log)
        logger.info(f"cmd = {' '.join(map(shlex.quote, cmd))}")
        sys.exit(subprocess.run(cmd, env=env).returncode)

    from deepspeed_tpu_torch.launcher.multinode_runner import get_runner

    runner = get_runner(args.launcher, args, active, master_addr)
    cmd = runner.get_cmd(env, active)
    logger.info(f"cmd = {' '.join(map(shlex.quote, cmd))}")
    sys.exit(subprocess.run(cmd, env=runner.export_env(env)).returncode)


if __name__ == "__main__":
    main()
