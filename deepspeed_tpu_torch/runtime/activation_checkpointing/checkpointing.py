"""Activation checkpointing: recompute a function's activations in the
backward instead of keeping them.

Counterpart of ``deepspeed_tpu/runtime/activation_checkpointing/
checkpointing.py`` (reference ``runtime/activation_checkpointing/
checkpointing.py``), with the same names, signatures and module globals.
``checkpoint(fn, *args)`` runs ``fn`` under the configured policy:

* by default, full recompute: ``torch.utils.checkpoint.checkpoint(...,
  use_reentrant=False)``, as the JAX ``nothing_saveable`` and
  ``models/common.py`` ``remat_call("full")``;
* ``cpu_checkpointing``: the JAX ``offload_dot_with_no_batch_dims("device",
  "pinned_host")``. The outputs of the matmuls without batch dimensions
  (``aten.mm`` / ``addmm``: a 3-D activation times a 2-D weight is one
  ``mm`` on the flattened rows) are kept, not recomputed, and they live in
  host memory (pinned when the activations are on the card): the forward
  copies each one out as it is made, and the recompute in the backward
  copies it back in place of running the matmul. Everything else is
  recomputed. The copies run on the compute stream, so each copy back
  follows its copy out.

``partition_activations`` splits saved activations over model-parallel
ranks in the reference; the port has no model parallelism (``mpu`` is a
later slice), so every rank keeps its activations whole, at world 1 as in
JAX and at any world. ``contiguous_memory_optimization`` parses and does
nothing: the caching allocator places what a checkpoint saves. With
``synchronize_checkpoint_boundary`` a checkpoint synchronizes the card
before and after its forward. ``number_checkpoints`` and ``profile`` parse
as in JAX.

The RNG tracker is the reference's: named states of the device's default
generator (the card's when there is one), ``fork(name)`` drawing from a
named one and leaving the default as it was. The port's models draw their
dropout from explicit generators, and a non-reentrant checkpoint replays
the default generator's state in its recompute, so none of them needs it;
it is here for client code that does.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from deepspeed_tpu_torch.utils.logging import log_dist

# module state (the reference and the JAX module keep the same globals)
_config = None
_policy: Optional[str] = None          # None: full recompute; "offload": cpu_checkpointing
deepspeed_checkpointing_enabled = False

PARTITION_ACTIVATIONS = False
CPU_CHECKPOINT = False
CONTIGUOUS_CHECKPOINTING = False
SYNCHRONIZE = False
PROFILE_TIME = False
num_layers = None

# the ops whose outputs cpu_checkpointing keeps on the host: the matmuls
# without batch dimensions (models/common.py's "dots")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def configure(mpu_=None, deepspeed_config=None, partition_activations: Optional[bool] = None,
              contiguous_checkpointing: Optional[bool] = None,
              num_checkpoints: Optional[int] = None, checkpoint_in_cpu: Optional[bool] = None,
              synchronize: Optional[bool] = None, profile: Optional[bool] = None):
    """Set the module's checkpointing behaviour from ``deepspeed_config`` (a
    ``DeepSpeedConfig`` or a ds_config dict) and the keyword arguments,
    which win over it (reference ``configure``)."""
    global _config, _policy, deepspeed_checkpointing_enabled
    global PARTITION_ACTIVATIONS, CPU_CHECKPOINT, CONTIGUOUS_CHECKPOINTING
    global SYNCHRONIZE, PROFILE_TIME, num_layers

    cfg = None
    if deepspeed_config is not None:
        cfg = getattr(deepspeed_config, "activation_checkpointing_config", None)
        if cfg is None and isinstance(deepspeed_config, dict):
            from deepspeed_tpu_torch.runtime.config import ActivationCheckpointingConfig

            cfg = ActivationCheckpointingConfig.from_dict(
                deepspeed_config.get("activation_checkpointing", {}))

    def pick(given, field, default):
        return given if given is not None else (getattr(cfg, field) if cfg else default)

    PARTITION_ACTIVATIONS = pick(partition_activations, "partition_activations", False)
    CPU_CHECKPOINT = pick(checkpoint_in_cpu, "cpu_checkpointing", False)
    CONTIGUOUS_CHECKPOINTING = pick(contiguous_checkpointing,
                                    "contiguous_memory_optimization", False)
    SYNCHRONIZE = pick(synchronize, "synchronize_checkpoint_boundary", False)
    PROFILE_TIME = pick(profile, "profile", False)
    num_layers = pick(num_checkpoints, "number_checkpoints", None)

    if PARTITION_ACTIVATIONS:
        log_dist("partition_activations: the port has no model-parallel group (mpu is a "
                 "later slice), so each rank keeps its activations whole", ranks=[0])
    if CONTIGUOUS_CHECKPOINTING:
        log_dist("contiguous_memory_optimization does nothing on CUDA here: PyTorch's "
                 "caching allocator places what a checkpoint saves", ranks=[0])
    # "offload" keeps the matmul outputs on the host; None is full recompute
    _policy = "offload" if CPU_CHECKPOINT else None
    _config = cfg
    deepspeed_checkpointing_enabled = True
    log_dist(f"activation checkpointing configured: partition_activations="
             f"{PARTITION_ACTIVATIONS} cpu_checkpointing={CPU_CHECKPOINT}", ranks=[0])


def is_configured() -> bool:
    return deepspeed_checkpointing_enabled


class _OffloadDots(TorchDispatchMode):
    """The forward's mode: each ``mm`` / ``addmm`` output is copied to host
    memory (pinned for a card's tensor) and kept in ``store``."""

    def __init__(self, store: List[torch.Tensor]):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _DOTS:
            host = torch.empty(out.shape, dtype=out.dtype, device="cpu",
                               pin_memory=out.is_cuda)
            self.store.append(host.copy_(out, non_blocking=out.is_cuda))
        return out


class _ReloadDots(TorchDispatchMode):
    """The recompute's mode: each ``mm`` / ``addmm`` takes its output back
    from the host, in the forward's order, instead of running."""

    def __init__(self, store: List[torch.Tensor]):
        super().__init__()
        self.store = store
        self.next = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in _DOTS:
            return func(*args, **(kwargs or {}))
        host = self.store[self.next]
        self.next += 1
        device = args[-1].device
        return host.to(device, non_blocking=device.type == "cuda")


def offload_contexts(store: Optional[List[torch.Tensor]] = None):
    """``context_fn`` of ``torch.utils.checkpoint.checkpoint`` for the
    "offload" policy; ``store`` (a new list when None) receives the host
    copies, in the forward's order."""
    store = [] if store is None else store
    return _OffloadDots(store), _ReloadDots(store)


def _run(function: Callable, args, policy: Optional[str]):
    if policy is None or policy in (True, "full"):
        return _torch_checkpoint(function, *args, use_reentrant=False)
    if policy == "offload":
        return _torch_checkpoint(function, *args, use_reentrant=False,
                                 context_fn=offload_contexts)
    from deepspeed_tpu_torch.models.common import remat_call

    return remat_call(policy, function, *args)


def checkpoint(function: Callable, *args, policy=None, prevent_cse: bool = True) -> Any:
    """``function(*args)`` with its activations recomputed in the backward
    (reference ``checkpoint``), under ``policy``: None for the configured
    one; "offload" (``cpu_checkpointing``'s); or one of
    ``models/common.py`` ``remat_call``'s ("full", "dots", "attn",
    "attn_mlp"). ``prevent_cse`` is JAX's argument and changes nothing."""
    pol = policy if policy is not None else _policy
    if not SYNCHRONIZE or not torch.cuda.is_available():
        return _run(function, args, pol)
    torch.cuda.synchronize()
    out = _run(function, args, pol)
    torch.cuda.synchronize()
    return out


def checkpoint_wrapper(function: Callable, policy=None) -> Callable:
    """Decorator form: ``function`` that runs through :func:`checkpoint`."""
    return lambda *args: checkpoint(function, *args, policy=policy)


def non_reentrant_checkpoint(function: Callable, *args) -> Any:
    """The reference's non-reentrant variant: :func:`checkpoint` (every
    checkpoint here is non-reentrant)."""
    return checkpoint(function, *args)


# ------------------------------------------------------------------ RNG
def _rng_device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def _get_rng_state() -> torch.Tensor:
    return torch.cuda.get_rng_state() if _rng_device() == "cuda" else torch.get_rng_state()


def _set_rng_state(state: torch.Tensor) -> None:
    if _rng_device() == "cuda":
        torch.cuda.set_rng_state(state)
    else:
        torch.set_rng_state(state)


class CudaRNGStatesTracker:
    """Named states of the device's default generator (reference
    ``CudaRNGStatesTracker``): ``add(name, seed)`` makes one from a seed,
    ``fork(name)`` draws from it inside a ``with`` block and leaves the
    default generator as it was."""

    _MODEL_PARALLEL_RNG = "model-parallel-rng"

    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed):
        self.seeds_.add(seed)
        outer = _get_rng_state()
        if _rng_device() == "cuda":
            torch.cuda.manual_seed(seed)
        else:
            torch.manual_seed(seed)
        self.states_[name] = _get_rng_state()
        _set_rng_state(outer)

    def get_states(self):
        return dict(self.states_)

    def set_states(self, states):
        self.states_ = dict(states)

    @contextlib.contextmanager
    def fork(self, name=_MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise KeyError(f"rng state {name!r} is not added")
        outer = _get_rng_state()
        _set_rng_state(self.states_[name])
        try:
            yield self
        finally:
            self.states_[name] = _get_rng_state()
            _set_rng_state(outer)


_CUDA_RNG_STATE_TRACKER = CudaRNGStatesTracker()


def get_cuda_rng_tracker() -> CudaRNGStatesTracker:
    return _CUDA_RNG_STATE_TRACKER


def model_parallel_cuda_manual_seed(seed: int) -> int:
    """The tracker's model-parallel state from ``seed + 2718`` (reference
    and JAX); with no tensor parallelism every rank's is the same."""
    tracker = get_cuda_rng_tracker()
    tracker.reset()
    tracker.add(CudaRNGStatesTracker._MODEL_PARALLEL_RNG, seed + 2718)
    return seed


def model_parallel_reconfigure_tp_seed(seed: int) -> int:
    return model_parallel_cuda_manual_seed(seed)


def partition_activations_in_checkpoint(partition_activation: bool) -> None:
    global PARTITION_ACTIVATIONS
    PARTITION_ACTIVATIONS = partition_activation


def set_num_layers(nlayers) -> None:
    global num_layers
    num_layers = nlayers


def reset() -> None:
    """The reference frees its contiguous buffers between batches; the port
    keeps none."""
    return None
