"""deepspeed_tpu_torch — the PyTorch and CUDA port of deepspeed_tpu.

The JAX package ``deepspeed_tpu`` is the reference; this package sits beside
it, mirrors its module paths, and imports neither it nor JAX. Every TPU
(Pallas) kernel on a ported path is a hand-written CUDA kernel here, built
from ``csrc/`` at first use. Entry points run on CUDA unless the caller
passes ``device="cpu"``.

Ported so far: serving (``init_inference`` → ``InferenceEngine.generate``)
of the llama family, and training on one card (``initialize`` →
``DeepSpeedEngine.train_batch``) of the GPT-2 family, with dense or
block-sparse (ds_config ``sparse_attention``) attention.
"""

from __future__ import annotations

import dataclasses

__version__ = "0.1.0"

from deepspeed_tpu_torch.accelerator import get_accelerator  # noqa: F401
from deepspeed_tpu_torch.utils.logging import log_dist, logger  # noqa: F401


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None, dist_init_required=None,
               collate_fn=None, config=None, config_params=None, device=None):
    """Create the training engine. Returns the reference's 4-tuple:
    (engine, optimizer, training dataloader, lr_scheduler); the dataloader is
    None (``training_data`` raises until the data loader is ported).
    ``model`` is an ``nn.Module`` with ``loss(batch)`` (and ``init_params``
    when its weights are not loaded yet); ``model_parameters`` may be a state
    dict for it. The engine runs on CUDA unless ``device="cpu"``."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    log_dist(f"deepspeed_tpu_torch {__version__} initialize()", ranks=[0])
    if config is None:
        config = config_params
    if config is None and args is not None and getattr(args, "deepspeed_config", None):
        config = args.deepspeed_config
    ds_config = DeepSpeedConfig(config if config is not None else {})
    if ds_config.sparse_attention and model is not None:
        _apply_sparse_attention(model, ds_config.sparse_attention)
    engine = DeepSpeedEngine(args=args, model=model, optimizer=optimizer,
                             model_parameters=model_parameters, training_data=training_data,
                             lr_scheduler=lr_scheduler, mpu=mpu,
                             dist_init_required=dist_init_required, collate_fn=collate_fn,
                             config_class=ds_config, device=device)
    return engine, engine.optimizer, None, engine.lr_scheduler


def _apply_sparse_attention(model, block: dict) -> None:
    """Copy the ds_config ``sparse_attention`` block into the model's config,
    which its attention dispatch reads, as the JAX ``initialize`` does."""
    mcfg = getattr(model, "config", None)
    if not hasattr(mcfg, "sparse_attention"):
        log_dist("ds_config sparse_attention set but the model does not support it "
                 "(no config.sparse_attention field); ignored", ranks=[0])
        return
    existing = mcfg.sparse_attention
    if existing is None:
        model.config = dataclasses.replace(mcfg, sparse_attention=dict(block))
        log_dist(f"sparse attention enabled: {block}", ranks=[0])
    elif dict(existing) != dict(block):
        raise ValueError("ds_config sparse_attention conflicts with the model's own "
                         f"config.sparse_attention (model: {existing}, ds_config: {dict(block)}); "
                         "set only one, or make them identical")


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
