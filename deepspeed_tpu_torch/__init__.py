"""deepspeed_tpu_torch — the PyTorch and CUDA port of deepspeed_tpu.

The JAX package ``deepspeed_tpu`` is the reference; this package sits beside
it, mirrors its module paths, and imports neither it nor JAX. Every TPU
(Pallas) kernel on a ported path is a hand-written CUDA kernel here, built
from ``csrc/`` at first use. Entry points run on CUDA unless the caller
passes ``device="cpu"``.

Ported so far: serving (``init_inference`` → ``InferenceEngine.generate``)
of the llama and GPT-2 families, from random or given weights or from a
training tag (``config={"checkpoint": save_dir}``), and training (``initialize`` →
``DeepSpeedEngine.train_batch``) of the GPT-2, llama and BERT families
and of MoE GPT-2 (``moe/``, expert parallelism over the ds_config ``tpu``
block's ``expert`` axis), with dense or
block-sparse (ds_config ``sparse_attention``) attention, fed by the data
loader and the curriculum pipeline, saved to and resumed from verified
checkpoints, on one process or over a ``torch.distributed`` world
(``comm``, ``init_distributed``) with ZeRO stages 0–3, with the state built
in its placement (``zero.Init``) and offloaded to host memory or NVMe
(ZeRO-Offload; ``offload_param: nvme`` returns the layerwise
``ZeroInfinityEngine``). A run over many processes starts from the command
line: ``python -m deepspeed_tpu_torch.launcher.runner [--hostfile H]
script.py --deepspeed_config ds.json`` spawns one process per GPU, and the
script takes ``add_config_arguments`` and calls
``get_accelerator().set_device(local_rank)``. The stable-diffusion stack
(``models/clip.py``, ``models/diffusion.py``: the CLIP text tower, the UNet
and the VAE, loaded from HF and diffusers by ``module_inject/hf.py``) serves
through ``init_inference`` → ``InferenceEngine.forward(sample, timestep,
context)``. The RLHF actor's path: ``hybrid_engine.enabled`` makes
``initialize`` return ``DeepSpeedHybridEngine`` (``generate`` over the live
training params), and the ``compression_training`` and ``eigenvalue``
blocks train with MoQ, pruning and the block Hessian eigenvalue
(``compression/``, ``runtime/eigenvalue.py``). The ``serving`` block puts
the request-lifecycle front-end (``serving/``: admission, deadlines, a
circuit breaker, drain) in front of an inference engine, and the
``telemetry`` block records the registry, spans and exporters of
``telemetry/``. A training run survives hangs, divergence and preemption
under the ``watchdog``, ``resilience.sentinel`` and ``rewind`` blocks
(``resilience/``), supervised by ``elasticity.DSElasticAgent``.
"""

from __future__ import annotations

import dataclasses

__version__ = "0.1.0"

import os

from deepspeed_tpu_torch.accelerator import get_accelerator  # noqa: F401
from deepspeed_tpu_torch.utils.logging import log_dist, logger  # noqa: F401
from deepspeed_tpu_torch import comm  # noqa: F401,E402
from deepspeed_tpu_torch.comm import init_distributed  # noqa: F401,E402


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None, dist_init_required=None,
               collate_fn=None, config=None, config_params=None, device=None):
    """Create the training engine. Returns the reference's 4-tuple:
    (engine, optimizer, training dataloader, lr_scheduler); the dataloader is
    the engine's loader over ``training_data`` (None without it).
    ``model`` is an ``nn.Module`` with ``loss(batch)`` (and ``init_params``
    when its weights are not loaded yet); ``model_parameters`` may be a state
    dict for it. The engine runs on CUDA unless ``device="cpu"``.

    ``dist_init_required`` True (or None under torchrun, whose ``RANK`` and
    ``WORLD_SIZE`` are set) joins the process group first
    (``comm.init_distributed``: NCCL on CUDA, gloo for ``device="cpu"``);
    the engine trains over whatever group is initialized. With
    ``hybrid_engine.enabled`` the engine is a ``DeepSpeedHybridEngine``,
    which also generates over its live params."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    log_dist(f"deepspeed_tpu_torch {__version__} initialize()", ranks=[0])
    if config is None:
        config = config_params
    if config is None and args is not None and getattr(args, "deepspeed_config", None):
        config = args.deepspeed_config
    ds_config = DeepSpeedConfig(config if config is not None else {})
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if dist_init_required or (dist_init_required is None and launched):
        comm.init_distributed(device=device)
    if ds_config.sparse_attention and model is not None:
        _apply_sparse_attention(model, ds_config.sparse_attention)
    off_param = ds_config.zero_config.offload_param
    if off_param is not None and off_param.device == "nvme":
        # ZeRO-Infinity's parameter offload is its own layerwise engine
        from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
        from deepspeed_tpu_torch.runtime.zero.infinity import ZeroInfinityEngine

        if hasattr(model, "expert_module_names"):
            # the JAX ZeroInfinityEngine takes any GPT2Model subclass and
            # walks only its dense stacked blocks, never a MoE expert bank;
            # the port refuses rather than copy that
            raise NotImplementedError("ZeRO-Infinity (offload_param nvme) of a MoE model: the "
                                      "layerwise engine walks only the dense blocks and would "
                                      "never load or update the expert banks")
        if ds_config.hybrid_engine.enabled:
            raise NotImplementedError("hybrid_engine with offload_param nvme: the layerwise "
                                      "ZeRO-Infinity engine has no generate")
        if optimizer is not None or lr_scheduler is not None:
            raise ValueError("offload_param=nvme (layerwise ZeRO-Infinity) builds its own "
                             "NVMe-swapped optimizer; pass optimizer/scheduler via ds_config, "
                             "not as objects")
        if model_parameters is not None:
            model.load_state_dict(model_parameters, assign=True)
        zengine = ZeroInfinityEngine(model, ds_config, device=device)
        loader = None if training_data is None else DeepSpeedDataLoader(
            training_data, batch_size=zengine.train_batch_size(), collate_fn=collate_fn)
        return zengine, zengine.optimizer, loader, zengine.lr_scheduler
    engine_cls = DeepSpeedEngine
    if ds_config.hybrid_engine.enabled:
        from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine

        engine_cls = DeepSpeedHybridEngine
    engine = engine_cls(args=args, model=model, optimizer=optimizer,
                        model_parameters=model_parameters, training_data=training_data,
                        lr_scheduler=lr_scheduler, mpu=mpu,
                        dist_init_required=dist_init_required, collate_fn=collate_fn,
                        config_class=ds_config, device=device)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler


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
    it, as in the JAX package. ``checkpoint`` (a training save dir, or one
    of its tag dirs; ``checkpoint_config={"tag": ...}`` picks a tag) serves
    that tag's params; ``params`` takes precedence over it.

    A Megatron-DeepSpeed checkpoint directory is served directly:
    ``checkpoint=<dir>`` with ``checkpoint_config={"type": "Megatron" |
    "Megatron-MoE", "n_head": N[, "tp_degree": T]}`` merges its tp grid and
    converts it (``checkpoint.load_megatron_gpt`` / ``load_megatron_moe``);
    without ``model`` it builds a ``GPT2Model`` (``MoEGPT2`` with
    ``drop_tokens=False``) of the checkpoint's widths in the serving dtype,
    with the decode kernel on (``use_flash_decode``). ``model`` may be None
    on this path only, and ``params`` takes precedence over the files, as
    in the JAX package."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    engine_kwargs = {k: kwargs.pop(k) for k in ("params", "device") if k in kwargs}
    if config is None:
        config = {}
    if isinstance(config, DeepSpeedInferenceConfig):
        if kwargs:
            config = DeepSpeedInferenceConfig.from_dict({**dataclasses.asdict(config), **kwargs})
    else:
        config = DeepSpeedInferenceConfig.from_dict({**config, **kwargs})
    if config.checkpoint and config.megatron_type and "params" not in engine_kwargs:
        model, engine_kwargs["params"] = _megatron_model(model, config)
        # the params are in memory now: no tag restore from the directory
        config = dataclasses.replace(config, checkpoint=None)
    if model is None:
        raise ValueError("init_inference needs a model (or a Megatron checkpoint: "
                         'checkpoint_config {"type": "Megatron", "n_head": N})')
    return InferenceEngine(model, config, **engine_kwargs)


def _megatron_model(model, config):
    """(the model, its state dict) of the Megatron checkpoint that
    ``config`` names; ``model`` None builds one."""
    cc = config.checkpoint_config
    n_head = cc.get("n_head") or cc.get("num_attention_heads")
    if not n_head:
        raise ValueError('checkpoint_config {"type": "Megatron"} needs "n_head" (or '
                         '"num_attention_heads"): Megatron layer files do not carry model args')
    dtype = config.torch_dtype()
    if config.megatron_type == "megatronmoe":
        from deepspeed_tpu_torch.checkpoint import load_megatron_moe
        from deepspeed_tpu_torch.models.gpt2_moe import MoEGPT2

        mcfg, params, n_experts = load_megatron_moe(config.checkpoint, n_head=int(n_head),
                                                    dtype=dtype, tp_degree=cc.get("tp_degree"))
        if model is None:
            model = MoEGPT2(dataclasses.replace(mcfg, use_flash_decode=True),
                            num_experts=n_experts, ep_size=config.ep_size, drop_tokens=False)
    else:
        from deepspeed_tpu_torch.checkpoint import load_megatron_gpt
        from deepspeed_tpu_torch.models.gpt2 import GPT2Model

        mcfg, params = load_megatron_gpt(config.checkpoint, n_head=int(n_head), dtype=dtype,
                                         tp_degree=cc.get("tp_degree"))
        if model is None:
            model = GPT2Model(dataclasses.replace(mcfg, use_flash_decode=True))
    return model, params


def add_config_arguments(parser):
    """Add the DeepSpeed arguments to an argparse parser: ``--deepspeed``,
    ``--deepspeed_config`` (the ds_config json that ``initialize(args=...)``
    reads) and ``--local_rank`` (launchers set ``LOCAL_RANK`` in the
    environment as well)."""
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag, parity only)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="Path to the ds_config json")
    group.add_argument("--local_rank", type=int, default=-1,
                       help="local rank passed by launchers (also LOCAL_RANK in the environment)")
    return parser
