"""Launcher package: the command line that starts a run over many processes.

Counterpart of ``deepspeed_tpu/launcher/`` (``runner.py``, the CLI;
``launch.py``, the per-host spawner; ``multinode_runner.py``, the ssh, pdsh
and slurm fan-outs). The JAX launcher runs one process per host, because
one JAX process owns every chip of its host; this one runs one process per
GPU, each with the ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT`` and ``CUDA_VISIBLE_DEVICES`` that
``comm.init_distributed`` reads:

    python -m deepspeed_tpu_torch.launcher.runner [--hostfile H] script.py --deepspeed_config ds.json
"""

from deepspeed_tpu_torch.launcher.runner import fetch_hostfile, main, parse_inclusion_exclusion  # noqa: F401
