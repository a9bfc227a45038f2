"""Multinode transport backends for the runner.

Counterpart of ``deepspeed_tpu/launcher/multinode_runner.py`` (the
reference's ``deepspeed/launcher/multinode_runner.py``): each backend
builds ONE command that starts ``python -m
deepspeed_tpu_torch.launcher.launch`` on every host with that host's
``--node_rank``; the host's launch.py then spawns one process per GPU. The
ssh, pdsh and slurm backends build the JAX package's commands. Slurm keeps
one task per node, as there, because launch.py spawns the GPUs. The JAX
package's gcloud backend is a Cloud-TPU fan-out (``gcloud compute tpus
tpu-vm ssh``) with no counterpart for GPU hosts: ``get_runner("gcloud")``
raises. The JAX package has no MPI backend, and neither has this one.
"""

from __future__ import annotations

import os
import shlex
from abc import ABC, abstractmethod
from typing import Dict, List

from deepspeed_tpu_torch.launcher.runner import EXPORT_ENVS, launch_cmd


class MultiNodeRunner(ABC):
    name = "base"

    def __init__(self, args, master_addr: str):
        self.args = args
        self.master_addr = master_addr

    def launch_cmd(self, node_rank, active: Dict[str, List[int]]) -> List[str]:
        return launch_cmd(active, self.master_addr, self.args.master_port, node_rank,
                          self.args.user_script, self.args.user_args,
                          self.args.enable_each_rank_log)

    def export_env(self, env: dict) -> dict:
        return env

    def exports(self, env: dict) -> Dict[str, str]:
        """The variables other hosts inherit (``EXPORT_ENVS``: exact names,
        or prefixes ending in "_")."""
        return {k: v for k, v in env.items()
                if any(k == p or (p.endswith("_") and k.startswith(p)) for p in EXPORT_ENVS)}

    def _export_line(self, env: dict) -> str:
        return " ".join(f"export {k}={shlex.quote(v)};" for k, v in self.exports(env).items())

    @abstractmethod
    def get_cmd(self, env: dict, active: Dict[str, List[int]]) -> List[str]:
        ...


class SSHRunner(MultiNodeRunner):
    """Plain ssh fan-out: one background ssh per host, and a shell that
    waits for each, so a remote failure becomes the exit code."""
    name = "ssh"

    def get_cmd(self, env, active):
        parts = []
        for rank, host in enumerate(active):
            remote = self._export_line(env) + f" cd {shlex.quote(os.getcwd())}; " + \
                " ".join(map(shlex.quote, self.launch_cmd(rank, active)))
            ssh = ["ssh", "-o", "StrictHostKeyChecking=no"]
            if self.args.launcher_args:
                ssh += shlex.split(self.args.launcher_args)
            parts.append(" ".join(map(shlex.quote, ssh + [host])) + " " + shlex.quote(remote))
        script = ("pids=(); " + " ".join(f"{p} & pids+=($!);" for p in parts) +
                  ' rc=0; for p in "${pids[@]}"; do wait "$p" || rc=$?; done; exit $rc')
        return ["/bin/bash", "-c", script]


class PDSHRunner(MultiNodeRunner):
    """pdsh fan-out: every host runs the same line, which finds its node
    rank by its hostname's place in the host list (full, short or FQDN
    form) and fails loudly when it is not there."""
    name = "pdsh"

    def get_cmd(self, env, active):
        hosts = list(active)
        env = self.export_env(env)
        hostlist = ",".join(hosts)
        rank_sh = ("HOSTS=({hosts}); NODE_RANK=; "
                   "for i in \"${{!HOSTS[@]}}\"; do "
                   "for n in \"$(hostname)\" \"$(hostname -s)\" \"$(hostname -f)\"; do "
                   "[ \"${{HOSTS[$i]}}\" = \"$n\" ] && NODE_RANK=$i; done; done; "
                   "[ -n \"$NODE_RANK\" ] || {{ echo \"deepspeed_tpu_torch: $(hostname) not in "
                   "hostfile ({hostlist})\" >&2; exit 3; }}; "
                   ).format(hosts=" ".join(hosts), hostlist=hostlist)
        remote = self._export_line(env) + f" cd {shlex.quote(os.getcwd())}; " + rank_sh + \
            " ".join(self.launch_cmd("$NODE_RANK", active))
        cmd = ["pdsh", "-S", "-f", "1024", "-w", hostlist]
        if self.args.launcher_args:
            cmd += shlex.split(self.args.launcher_args)
        return cmd + [remote]

    def export_env(self, env):
        return {**env, "PDSH_RCMD_TYPE": "ssh"}


class SlurmRunner(MultiNodeRunner):
    """srun, one task per node; each takes its node rank from
    ``SLURM_NODEID``."""
    name = "slurm"

    def get_cmd(self, env, active):
        hosts = list(active)
        cmd = ["srun", "--nodes", str(len(hosts)), "--ntasks-per-node", "1",
               "--nodelist", ",".join(hosts)]
        if self.args.launcher_args:
            cmd += shlex.split(self.args.launcher_args)
        return cmd + ["bash", "-c", " ".join(self.launch_cmd("$SLURM_NODEID", active))]


_RUNNERS = {r.name: r for r in (SSHRunner, PDSHRunner, SlurmRunner)}


def get_runner(name: str, args, active, master_addr: str) -> MultiNodeRunner:
    if name == "local":
        name = "ssh"
    if name == "gcloud":
        raise ValueError("launcher 'gcloud' is the JAX package's Cloud-TPU fan-out "
                         "(gcloud compute tpus tpu-vm ssh) and has no counterpart for GPU "
                         f"hosts; choose one of {sorted(_RUNNERS)}")
    if name not in _RUNNERS:
        raise ValueError(f"unknown launcher {name!r}; choices: {sorted(_RUNNERS)}")
    return _RUNNERS[name](args, master_addr)
