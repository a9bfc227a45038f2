"""deepspeed_tpu_torch — the PyTorch and CUDA port of deepspeed_tpu.

The JAX package ``deepspeed_tpu`` is the reference; this package sits beside
it, mirrors its module paths, and imports neither it nor JAX. Every TPU
(Pallas) kernel on a ported path is a hand-written CUDA kernel here, built
from ``csrc/`` at first use. Entry points run on CUDA unless the caller
passes ``device="cpu"``.

Ported so far: serving (``init_inference`` → ``InferenceEngine.generate``)
of the llama family.
"""

from __future__ import annotations

import dataclasses

__version__ = "0.1.0"

from deepspeed_tpu_torch.accelerator import get_accelerator  # noqa: F401
from deepspeed_tpu_torch.utils.logging import log_dist, logger  # noqa: F401


def init_inference(model=None, config=None, **kwargs):
    """Create an InferenceEngine. ``config`` is a dict of ds_config inference
    keys or a DeepSpeedInferenceConfig; extra keyword arguments other than
    ``params`` (a state dict for ``model``) and ``device`` are merged into
    it, as in the JAX package."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    if model is None:
        raise ValueError("init_inference needs a model")
    engine_kwargs = {k: kwargs.pop(k) for k in ("params", "device") if k in kwargs}
    if config is None:
        config = {}
    if isinstance(config, DeepSpeedInferenceConfig):
        if kwargs:
            config = DeepSpeedInferenceConfig.from_dict({**dataclasses.asdict(config), **kwargs})
    else:
        config = DeepSpeedInferenceConfig.from_dict({**config, **kwargs})
    return InferenceEngine(model, config, **engine_kwargs)
