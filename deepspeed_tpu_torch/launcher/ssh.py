"""``python -m deepspeed_tpu_torch.launcher.ssh [-f HOSTFILE] COMMAND...``:
run one shell command on every host of a hostfile.

Counterpart of ``bin/ds_ssh``. The hostfile is the launcher's
(``hostname slots=N`` lines, ``launcher/runner.py`` ``fetch_hostfile``);
without one the command runs here only. ``localhost`` runs locally, any
other host through ``ssh``. Each host's output is printed under its name
and return code, and the exit code is the first non-zero one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from deepspeed_tpu_torch.launcher.runner import fetch_hostfile

LOCAL_HOSTS = ("localhost", "127.0.0.1")


def main(argv=None) -> int:
    p = argparse.ArgumentParser("ds_ssh", description=__doc__.splitlines()[0])
    p.add_argument("-f", "--hostfile", default="/job/hostfile")
    p.add_argument("command", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if not args.command:
        p.error("no command given")
    if not os.path.isfile(args.hostfile):
        print(f"hostfile {args.hostfile} not found; running locally only")
        hosts = ["localhost"]
    else:
        hosts = list(fetch_hostfile(args.hostfile))
    cmd = " ".join(args.command)
    procs = []
    for h in hosts:
        full = cmd if h in LOCAL_HOSTS else ["ssh", "-o", "StrictHostKeyChecking=no", h, cmd]
        procs.append((h, subprocess.Popen(full, shell=isinstance(full, str),
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True)))
    rc = 0
    for h, proc in procs:
        out, _ = proc.communicate()
        print(f"----- {h} (rc={proc.returncode})\n{out}")
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
