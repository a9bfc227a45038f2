"""MoE layer: the user-facing module.

Counterpart of ``deepspeed_tpu/moe/layer.py`` (the reference's
``deepspeed/moe/layer.py`` ``MoE``): :class:`TopKGate`, :class:`Experts`
and :class:`MOELayer` together, with the optional residual MLP of
Residual-MoE (``out = moe(x) * c0 + mlp(x) * c1``, the coefficients a
softmax in fp32). ``num_experts`` must divide by ``ep_size``; this rank
holds the ``ep_rank``-th ``num_experts / ep_size`` of them (by default the
rank's coordinate on the expert axis, ``rank % ep_size``). The groups the
layer exchanges over are the engine's (``utils/groups.py``), passed in at
each call.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

from torch import nn

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models.common import meta_weight
from deepspeed_tpu_torch.moe.experts import Experts
from deepspeed_tpu_torch.moe.sharded_moe import MOELayer, TopKGate, gelu_tanh, own_weights
from deepspeed_tpu_torch.utils.logging import log_dist


def default_ep_rank(ep_size: int) -> int:
    """This process's coordinate on an expert axis of ``ep_size``: the grid
    places ``expert`` innermost (rank = d * ep + x)."""
    return comm.get_rank() % ep_size if comm.is_initialized() else 0


class _Residual(nn.Module):
    """The residual MLP: one expert's weights, unstacked."""

    def __init__(self, d: int, h: int):
        super().__init__()
        self.wi, self.bi = meta_weight(d, h), meta_weight(h)
        self.wo, self.bo = meta_weight(h, d), meta_weight(d)


class MoE(nn.Module):
    def __init__(self, hidden_size: int, expert: Optional[nn.Module] = None,
                 num_experts: int = 1, ep_size: int = 1, k: int = 1,
                 capacity_factor: float = 1.0, eval_capacity_factor: float = 1.0,
                 min_capacity: int = 4, use_residual: bool = False,
                 noisy_gate_policy: Optional[str] = None, drop_tokens: bool = True,
                 expert_hidden: Optional[int] = None, activation: Callable = gelu_tanh,
                 ep_rank: Optional[int] = None):
        super().__init__()
        if num_experts % max(1, ep_size):
            raise ValueError(f"num_experts {num_experts} must divide by ep_size {ep_size}")
        self.hidden_size, self.num_experts, self.ep_size = hidden_size, num_experts, ep_size
        self.ep_rank = default_ep_rank(ep_size) if ep_rank is None else ep_rank
        self.use_residual = use_residual
        local = num_experts // ep_size
        self.experts = expert or Experts(num_experts, hidden_size,
                                         expert_hidden or 4 * hidden_size, activation,
                                         num_local=local, first=self.ep_rank * local)
        self.gate = TopKGate(hidden_size, num_experts, k, capacity_factor,
                             eval_capacity_factor, min_capacity, noisy_gate_policy, drop_tokens)
        self.moe_layer = MOELayer(self.gate, self.experts, num_experts)
        if use_residual:
            self.residual = _Residual(hidden_size, 4 * hidden_size)
            self.coefficient = meta_weight(hidden_size, 2)
        log_dist(f"MoE layer: {num_experts} experts, ep_size={ep_size}, top-{k}", ranks=[0])

    def param_chunks(self, pieces, prefix: str = ""):
        """The random initial values: the gate's, the experts' (this rank's),
        and the residual MLP's and zero coefficients when used."""
        yield from self.gate.param_chunks(pieces, f"{prefix}gate.")
        yield from self.experts.param_chunks(pieces, f"{prefix}experts.")
        if self.use_residual:
            d, h = self.hidden_size, 4 * self.hidden_size
            yield from pieces(f"{prefix}residual.wi", (d, h), 1.0 / math.sqrt(d))
            yield from pieces(f"{prefix}residual.bi", (h,))
            yield from pieces(f"{prefix}residual.wo", (h, d), 1.0 / math.sqrt(h))
            yield from pieces(f"{prefix}residual.bo", (d,))
            yield from pieces(f"{prefix}coefficient", (d, 2))

    def forward(self, x, train: bool = True, generator=None, groups=None, noise=None,
                gathered: Callable = own_weights):
        """x (..., hidden) → (out, l_aux); the arguments are
        :meth:`MOELayer.forward`'s."""
        out, l_aux = self.moe_layer(x, train, generator, groups, noise, gathered)
        if self.use_residual:
            flat = x.reshape(-1, x.shape[-1])
            with gathered(self.residual) as r:
                mlp_out = self.experts.apply_one(r, flat).reshape(x.shape)
            with gathered(self) as own:
                coef = (x.float() @ own.coefficient.float()).softmax(dim=-1)
            out = out * coef[..., 0:1].to(x.dtype) + mlp_out * coef[..., 1:2].to(x.dtype)
        return out, l_aux
