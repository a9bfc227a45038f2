"""Distributed-aware logging.

Counterpart of ``deepspeed_tpu/utils/logging.py``: a singleton logger plus
``log_dist``, which emits only on chosen ranks. The rank is
``torch.distributed``'s when a process group is up, else ``$RANK``.
"""

from __future__ import annotations

import functools
import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}

_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d:%(funcName)s] %(message)s"


@functools.lru_cache(None)
def _create_logger(name: str, level: int) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    handler = logging.StreamHandler(stream=sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT))
    lg.addHandler(handler)
    return lg


def _default_level() -> int:
    return LOG_LEVELS.get(os.environ.get("DSTPU_LOG_LEVEL", "info").lower(), logging.INFO)


logger = _create_logger("DeepSpeedTorch", _default_level())


def _rank() -> int:
    """Global rank; safe to call before a process group exists."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def log_dist(message: str, ranks=None, level: int = logging.INFO) -> None:
    """Log ``message`` only on the given ranks (``[-1]`` or None = all)."""
    my_rank = _rank()
    if ranks is None or len(ranks) == 0 or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
