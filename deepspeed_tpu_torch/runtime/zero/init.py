"""zero.Init: parameters built straight into their ZeRO placement.

Counterpart of ``deepspeed_tpu/runtime/zero/init.py`` (the reference's
``zero/partition_parameters.py`` ``Init``). There, ``materialize`` jits the
init function with the ZeRO-3 plan's output shardings, so XLA allocates
each parameter in its shard. Here a model's parameters are random draws a
piece at a time (``GPT2Model.param_chunks``), and ``ZeroState`` is built
from those pieces unit by unit: each rank draws every piece in the same
order from the same seed (so the values equal the whole-tree build's) and
keeps only its part of each unit, in the unit's placement: the rank's shard
at stage 3, host memory under ``offload_param``. No rank ever holds a whole
partitioned unit, and beyond the state the build holds one piece.

The engine's own init goes the same way (:func:`build_state`), so a model
too large for the card is never whole on it: the card holds the compute-type
params (or their shards) and one piece of fp32 during init.

    with zero.Init(config={"zero_optimization": {"stage": 3}}):
        state = zero.materialize(model, torch.Generator("cuda").manual_seed(0))

``materialize`` returns the model's ``ZeroState`` (its fp32 copy dropped):
``state.to_host(PARAMS)`` reads the whole values back. ``initialize`` takes
a model materialized this way and adopts the parts each rank holds, when its
own plan places them the same way.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional

import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.parallel.topology import ParallelGrid
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.runtime.zero.partition import plan_partition
from deepspeed_tpu_torch.runtime.zero.state import Chunk, ZeroState
from deepspeed_tpu_torch.utils.logging import log_dist

_ACTIVE: List["Init"] = []


def trainable(model: torch.nn.Module):
    """The model's trainable parameters ``(name, param, owning module's name,
    owning module)``, in ``named_parameters`` order."""
    owner = {id(p): (mname, m) for mname, m in model.named_modules()
             for p in m.parameters(recurse=False)}
    return [(n, p, *owner[id(p)]) for n, p in model.named_parameters() if p.requires_grad]


def _rebind_meta(model: torch.nn.Module, device, dtype) -> None:
    """Give every parameter still on the meta device an empty one on
    ``device`` (a meta tensor cannot take another's data)."""
    for m in model.modules():
        for name, p in list(m._parameters.items()):
            if p is not None and p.is_meta:
                m._parameters[name] = torch.nn.Parameter(
                    torch.empty(0, dtype=dtype, device=device), requires_grad=p.requires_grad)


def build_state(model: torch.nn.Module, stage: int, persistence_threshold: int,
                dtype: torch.dtype, device: torch.device, grad_dtype=torch.float32,
                generator: Optional[torch.Generator] = None, group=None, rank: int = 0,
                world: int = 1, **placement) -> ZeroState:
    """``model``'s ZeroState at ``stage`` over ``group``, built unit by unit
    in its placement (``placement``: ZeroState's ``fp32_host``,
    ``param_host``, ``pin`` and ``fp32_sink``).

    The values come, in order of preference, from the ZeroState of a
    ``materialize`` of the model (the parts this rank holds; the plans must
    agree), from ``generator`` when the model's weights are not loaded (on
    the meta device), or from the model's weights (broadcast from rank 0).
    Parameters not trained keep their values, moved to ``device``."""
    named = trainable(model)
    if not named:
        raise ValueError("the model has no trainable parameters")
    made = getattr(model, "param_gatherer", None)
    made = made if isinstance(made, ZeroState) else None
    shapes = {n: (tuple(made.plan.params[i].shape) if made is not None else tuple(p.shape))
              for i, (n, p, _, _) in enumerate(named)}
    plan = plan_partition([(n, shapes[n], owner) for n, _, owner, _ in named], stage, world,
                          persistence_threshold)
    index = {n: i for i, (n, _, _, _) in enumerate(named)}
    meta = any(p.is_meta for p in model.parameters())
    if meta and made is None and not hasattr(model, "param_chunks"):
        if generator is None:
            raise ValueError("the model's weights are not loaded and no generator was given")
        model.init_params(generator)              # the whole tree, then as given weights
        named, meta = trainable(model), False
    if made is not None:
        if made.plan != plan:
            raise ValueError("the model was materialized under zero.Init with another ZeRO "
                             "plan (stage, world or persistence threshold) than the engine's")
        chunks, broadcast = made.local_chunks(), False
    elif meta:
        if generator is None:
            raise ValueError("the model's weights are not loaded and no generator was given")
        shapes = {n: p.shape for n, p in model.named_parameters()}
        chunks, broadcast = _trained_chunks(model, generator, index, shapes), False
    else:
        chunks = ((index[n], 0, p.detach()) for n, p, _, _ in named)
        broadcast = True
    _rebind_meta(model, device, dtype)
    for _, p in model.named_parameters():
        if not p.requires_grad:
            p.data = p.data.to(device, dtype if p.is_floating_point() else p.dtype)
    named = trainable(model)
    return ZeroState(plan, [p for _, p, _, _ in named], [m for _, _, _, m in named], chunks,
                     dtype, grad_dtype, device, group, rank, broadcast=broadcast, **placement)


def _trained_chunks(model, generator, index, shapes) -> Iterator[Chunk]:
    """The model's random pieces (``param_chunks``) of the trained
    parameters as ZeroState chunks; an untrained parameter's pieces are
    assembled and assigned to it."""
    untrained: Dict[str, torch.Tensor] = {}
    for name, start, values in model.param_chunks(generator):
        if name in index:
            yield index[name], start, values
            continue
        t = untrained.setdefault(name, torch.empty(shapes[name], device=values.device))
        t.view(-1)[start:start + values.numel()] = values
    for name, t in untrained.items():
        mod, _, leaf = name.rpartition(".")
        owner = model.get_submodule(mod) if mod else model
        owner._parameters[leaf] = torch.nn.Parameter(t, requires_grad=False)


class Init(contextlib.AbstractContextManager):
    """``with zero.Init(config=ds_config): state = zero.materialize(model,
    generator)``.

    ``config`` (or ``config_dict_or_path``): a ds_config dict, its
    ``zero_optimization`` block or a ``DeepSpeedZeroConfig``; stage 3 when
    absent. ``remote_device="cpu"`` or the block's ``offload_param`` to
    ``cpu`` keeps the compute-type params in host memory (pinned on a CUDA
    device, or with ``pin_memory``). ``dtype``: the params' type (fp32 by
    default, the init function's own, as in the JAX package). ``device``:
    the card unless ``"cpu"``. The ranks are the default process group's,
    or a world of one. ``module`` and ``mpu`` are the reference's arguments
    and change nothing."""

    def __init__(self, module=None, config=None, config_dict_or_path=None,
                 remote_device: Optional[str] = None, pin_memory: bool = False, dtype=None,
                 enabled: bool = True, mpu=None, device=None):
        cfg = config if config is not None else config_dict_or_path
        if isinstance(cfg, DeepSpeedZeroConfig):
            self.zero_config = cfg
        elif isinstance(cfg, dict):
            self.zero_config = DeepSpeedZeroConfig.from_dict(cfg.get("zero_optimization", cfg))
        else:
            self.zero_config = DeepSpeedZeroConfig(stage=3)
        off = self.zero_config.offload_param
        host = remote_device or (off.device if off is not None else "none")
        if host not in ("none", "cpu"):
            raise ValueError(f"zero.Init places parameters on the card or in host memory "
                             f"(remote_device 'cpu'), not {host!r}: NVMe-resident parameters "
                             "are ZeRO-Infinity's (initialize with offload_param nvme)")
        self.param_host = host == "cpu"
        self.pin = pin_memory or (off is not None and off.pin_memory)
        self.enabled = enabled
        self.dtype = dtype or torch.float32
        self.device = device

    def __enter__(self):
        if self.enabled:
            _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        if self.enabled and _ACTIVE and _ACTIVE[-1] is self:
            _ACTIVE.pop()
        return False

    def materialize(self, init_fn, *args, **kwargs):
        """``init_fn``: a model (an ``nn.Module`` with ``param_chunks``, or
        ``init_params`` for the whole tree at once) or one of those bound
        methods; ``args``: its generator. Returns the model's ZeroState, every parameter in its
        placement; disabled, ``init_fn(*args)`` as it is."""
        if not self.enabled:
            return init_fn(*args, **kwargs)
        model = init_fn if isinstance(init_fn, torch.nn.Module) else init_fn.__self__
        generator = args[0] if args else kwargs["generator"]
        device = resolve_device(self.device)
        grid = ParallelGrid()
        group, world = grid.get_data_parallel_group(), grid.get_data_parallel_world_size()
        rank = grid.get_data_parallel_rank()
        state = build_state(model, self.zero_config.stage,
                            self.zero_config.param_persistence_threshold, self.dtype, device,
                            generator=generator, group=group, rank=rank, world=world,
                            param_host=self.param_host,
                            pin=device.type == "cuda" and (self.param_host or self.pin),
                            fp32_sink=lambda u, t: None)
        if any(state.fetched):
            model.param_gatherer = state
        n = sum(p.numel for p in state.plan.params)
        log_dist(f"zero.Init: materialized {n / 1e6:.1f}M params at ZeRO stage "
                 f"{state.stage} over {world} rank(s)"
                 + (", in host memory" if self.param_host else ""), ranks=[0])
        return state


def materialize(init_fn, *args, **kwargs):
    """:meth:`Init.materialize` of the innermost active ``with
    zero.Init(...)`` (raises outside one)."""
    if not _ACTIVE:
        raise RuntimeError("zero.materialize() requires an active `with zero.Init(...)` context")
    return _ACTIVE[-1].materialize(init_fn, *args, **kwargs)
