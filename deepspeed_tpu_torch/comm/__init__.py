"""The communication layer over ``torch.distributed`` (``comm.py``)."""

from deepspeed_tpu_torch.comm.comm import *  # noqa: F401,F403
