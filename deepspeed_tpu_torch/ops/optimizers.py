"""Optimizer update rules on fp32 tensors.

Counterpart of ``deepspeed_tpu/ops/optimizers.py`` (the reference's
FusedAdam, FusedLamb, Lion, Adagrad and SGD semantics). The JAX package
computes these updates in XLA, not in Pallas, so here they are plain torch
ops, applied in place under ``torch.no_grad`` to the fp32 tensors the
engine optimizes (the masters, or the params when they are fp32). They keep
the reference semantics — ``adam_w_mode``, the bias corrections, LAMB's
per-tensor trust ratio — rather than calling ``torch.optim``.

Each factory returns an :class:`Optimizer`: ``init(params)`` → state, and
``update(grads, state, params, lr)`` → new state, which updates ``params``
and the state's tensors in place. Moments are fp32 whatever the params'
type.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch

from deepspeed_tpu_torch.utils.logging import logger

Tensors = Sequence[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init(params)`` → state; ``update(grads, state, params, lr=...)`` →
    state, updating ``params`` in place. ``lr`` defaults to the factory's;
    the engine passes its schedule's value every step."""
    init: Callable[[Tensors], Any]
    update: Callable[..., Any]


def _zeros_like(params: Tensors) -> List[torch.Tensor]:
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]


class AdamState(NamedTuple):
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adam_bias_corrections(count: int, b1: float, b2: float, bias_correction: bool = True):
    if bias_correction:
        return 1 - b1 ** count, 1 - b2 ** count
    return 1.0, 1.0


@torch.no_grad()
def adam_leaf_update(p, m, v, g, lr, b1, b2, eps, weight_decay, adam_w_mode, bc1, bc2):
    """One tensor of FusedAdam, in place on the fp32 ``p``, ``m``, ``v``:
    the single source of the Adam/AdamW math (reference
    ops/adam/fused_adam.py semantics)."""
    g = g.float()
    if weight_decay != 0.0 and not adam_w_mode:
        # classic (L2) mode folds decay into the gradient before the moments
        g = g + weight_decay * p
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).add_(torch.square(g), alpha=1 - b2)
    step = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
    if weight_decay != 0.0 and adam_w_mode:
        step.add_(p, alpha=weight_decay)
    p.add_(step, alpha=-lr)


def fused_adam(lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
               weight_decay: float = 0.0, adam_w_mode: bool = True,
               bias_correction: bool = True, amsgrad: bool = False) -> Optimizer:
    """Adam/AdamW with the reference FusedAdam's semantics (``adam_w_mode``
    selects decoupled decay)."""
    if amsgrad:
        raise ValueError("FusedAdam does not support amsgrad (parity with reference)")
    b1, b2 = betas

    def init(params):
        return AdamState(count=0, mu=_zeros_like(params), nu=_zeros_like(params))

    def update(grads, state, params, lr=lr):
        count = state.count + 1
        bc1, bc2 = adam_bias_corrections(count, b1, b2, bias_correction)
        for p, m, v, g in zip(params, state.mu, state.nu, grads):
            adam_leaf_update(p, m, v, g, lr, b1, b2, eps, weight_decay, adam_w_mode, bc1, bc2)
        return state._replace(count=count)

    return Optimizer(init, update)


def fused_lamb(lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-6,
               weight_decay: float = 0.0, max_coeff: float = 10.0,
               min_coeff: float = 0.01, bias_correction: bool = True) -> Optimizer:
    """LAMB: the Adam direction scaled per tensor by the trust ratio
    ||w|| / ||update||, clamped to [min_coeff, max_coeff]."""
    b1, b2 = betas

    def init(params):
        return AdamState(count=0, mu=_zeros_like(params), nu=_zeros_like(params))

    @torch.no_grad()
    def update(grads, state, params, lr=lr):
        count = state.count + 1
        bc1, bc2 = adam_bias_corrections(count, b1, b2, bias_correction)
        for p, m, v, g in zip(params, state.mu, state.nu, grads):
            g = g.float()
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).add_(torch.square(g), alpha=1 - b2)
            u = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
            if weight_decay != 0.0:
                u.add_(p, alpha=weight_decay)
            w_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
            trust = torch.where((w_norm > 0) & (u_norm > 0),
                                torch.clamp(w_norm / u_norm, min_coeff, max_coeff),
                                torch.ones_like(w_norm))
            p.sub_(lr * trust * u)
        return state._replace(count=count)

    return Optimizer(init, update)


class LionState(NamedTuple):
    mu: List[torch.Tensor]


def lion(lr: float = 1e-4, betas=(0.9, 0.99), weight_decay: float = 0.0) -> Optimizer:
    """Lion: the sign of an interpolated momentum."""
    b1, b2 = betas

    def init(params):
        return LionState(mu=_zeros_like(params))

    @torch.no_grad()
    def update(grads, state, params, lr=lr):
        for p, m, g in zip(params, state.mu, grads):
            g = g.float()
            u = torch.sign(b1 * m + (1 - b1) * g)
            if weight_decay != 0.0:
                u.add_(p, alpha=weight_decay)
            p.add_(u, alpha=-lr)
            m.mul_(b2).add_(g, alpha=1 - b2)
        return state

    return Optimizer(init, update)


class AdagradState(NamedTuple):
    accum: List[torch.Tensor]


def adagrad(lr: float = 1e-2, eps: float = 1e-10, weight_decay: float = 0.0,
            initial_accumulator_value: float = 0.0) -> Optimizer:
    """Adagrad (reference csrc/adagrad/cpu_adagrad.cpp semantics)."""

    def init(params):
        return AdagradState(accum=[torch.full(p.shape, float(initial_accumulator_value),
                                              dtype=torch.float32, device=p.device)
                                   for p in params])

    @torch.no_grad()
    def update(grads, state, params, lr=lr):
        for p, a, g in zip(params, state.accum, grads):
            g = g.float()
            a.add_(torch.square(g))
            u = g / (torch.sqrt(a) + eps)
            if weight_decay != 0.0:
                u.add_(p, alpha=weight_decay)
            p.add_(u, alpha=-lr)
        return state

    return Optimizer(init, update)


class SGDState(NamedTuple):
    mu: Optional[List[torch.Tensor]]


def sgd(lr: float = 1e-3, momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        return SGDState(mu=_zeros_like(params) if momentum else None)

    @torch.no_grad()
    def update(grads, state, params, lr=lr):
        for i, (p, g) in enumerate(zip(params, grads)):
            g = g.float()
            if weight_decay != 0.0:
                g = g + weight_decay * p
            if momentum:
                m = state.mu[i]
                m.mul_(momentum).add_(g)
                g = g + momentum * m if nesterov else m
            p.add_(g, alpha=-lr)
        return state

    return Optimizer(init, update)


# name → factory, as the engine's ds_config "optimizer.type" names them
OPTIMIZER_REGISTRY = {
    "adam": fused_adam,
    "adamw": lambda **kw: fused_adam(adam_w_mode=True,
                                     **{k: v for k, v in kw.items() if k != "adam_w_mode"}),
    "lamb": fused_lamb,
    "lion": lion,
    "sgd": sgd,
    "adagrad": adagrad,
}


def build_optimizer(name: str, params_cfg: dict) -> Optimizer:
    """The optimizer a ds_config ``optimizer`` block names, with its
    torch-style params (``lr``, ``betas``, ``eps``, ``weight_decay``, ...)."""
    name = name.lower()
    if name in ("onebitadam", "zerooneadam", "onebitlamb"):
        raise NotImplementedError(f"{name} (compressed-communication optimizer): "
                                  "later slice of the port")
    if name not in OPTIMIZER_REGISTRY:
        raise ValueError(f"Unknown optimizer {name}; known: {list(OPTIMIZER_REGISTRY)}")
    cfg = dict(params_cfg)
    kwargs = {}
    if "lr" in cfg:
        kwargs["lr"] = cfg.pop("lr")
    if "betas" in cfg:
        kwargs["betas"] = tuple(cfg.pop("betas"))
    for k in ("eps", "weight_decay", "momentum", "nesterov", "bias_correction",
              "adam_w_mode", "max_coeff", "min_coeff", "amsgrad", "initial_accumulator_value"):
        if k in cfg:
            kwargs[k] = cfg.pop(k)
    cfg.pop("torch_adam", None)
    cfg.pop("fused", None)
    if cfg:
        logger.warning(f"Ignoring unsupported optimizer params for {name}: {list(cfg)}")
    return OPTIMIZER_REGISTRY[name](**kwargs)
