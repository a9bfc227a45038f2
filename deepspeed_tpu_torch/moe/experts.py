"""Expert bank: stacked FFN experts.

Counterpart of ``deepspeed_tpu/moe/experts.py`` (the reference's
``deepspeed/moe/experts.py``). The JAX bank is one stacked pytree applied
by ``vmap`` of ``apply_one``; here it is four stacked parameters, ``wi``
(E_local, D, H), ``bi`` (E_local, H), ``wo`` (E_local, H, D) and ``bo``
(E_local, D), held in fp32 by the engine as every parameter is and applied
in the compute type by ``torch.bmm`` over this rank's experts (the JAX
package computes the same plain products outside Pallas). Under expert
parallelism a rank holds ``E / ep`` experts, those of its expert-parallel
coordinate.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from deepspeed_tpu_torch.models.common import meta_weight
from deepspeed_tpu_torch.moe.sharded_moe import gelu_tanh


class Experts(nn.Module):
    """``num_local`` of ``num_experts`` stacked 2-layer FFN experts, the
    ``first``-th on; ``activation`` is ``jax.nn.gelu``'s default, the tanh
    approximation."""

    def __init__(self, num_experts: int, model_dim: int, hidden_dim: int,
                 activation: Callable = gelu_tanh, num_local: int = None, first: int = 0):
        super().__init__()
        self.num_experts, self.model_dim, self.hidden_dim = num_experts, model_dim, hidden_dim
        self.num_local = num_experts if num_local is None else num_local
        self.first = first
        self.activation = activation
        E, D, H = self.num_local, model_dim, hidden_dim
        self.wi, self.bi = meta_weight(E, D, H), meta_weight(E, H)
        self.wo, self.bo = meta_weight(E, H, D), meta_weight(E, D)

    def param_chunks(self, pieces, prefix: str):
        """The random initial values as ``(name, start, values)`` pieces:
        normal / sqrt(fan-in) weights drawn expert by expert for all
        ``num_experts`` (the stream does not depend on the expert-parallel
        size), this rank's kept; zero biases."""
        D, H = self.model_dim, self.hidden_dim
        for key, shape, scale in (("wi", (D, H), 1.0 / math.sqrt(D)),
                                  ("wo", (H, D), 1.0 / math.sqrt(H))):
            n = shape[0] * shape[1]
            for e in range(self.num_experts):
                for name, start, values in pieces(key, shape, scale):
                    if self.first <= e < self.first + self.num_local:
                        yield f"{prefix}{name}", (e - self.first) * n + start, values
        for key, width in (("bi", H), ("bo", D)):
            yield from pieces(f"{prefix}{key}", (self.num_local, width))

    def apply_one(self, w, x):
        """Expert ``w`` (its wi, bi, wo, bo) on tokens x (C, D)."""
        h = x @ w.wi.to(x.dtype) + w.bi.to(x.dtype)
        return self.activation(h) @ w.wo.to(x.dtype) + w.bo.to(x.dtype)

    def forward(self, x, w=None):
        """x (E_local, C, D) → (E_local, C, D), each expert on its rows;
        ``w``: the gathered weights (the module's own by default)."""
        w = self if w is None else w
        h = torch.bmm(x, w.wi.to(x.dtype)) + w.bi.to(x.dtype)[:, None]
        h = self.activation(h)
        return torch.bmm(h, w.wo.to(x.dtype)) + w.bo.to(x.dtype)[:, None]
