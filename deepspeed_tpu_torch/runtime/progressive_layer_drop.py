"""Progressive Layer Drop (PLD): the keep-probability schedule and its gates.

Counterpart of ``deepspeed_tpu/runtime/progressive_layer_drop.py`` (the
reference's ``ProgressiveLayerDrop``, arXiv:2010.13369). θ(t) anneals from 1
to the configured floor θ̄ at rate γ: ``theta_at``. Block l of L is kept with
probability ``1 - (l+1)/L · (1 - θ)`` (``layer_keep_probs``), a kept block's
residual contribution scaled by 1/p so the forward's expectation holds and
serving (no θ) needs no rescale; the models draw the gates before their
layer loop (``models/common.py`` ``pld_gates``).

The engine passes ``theta_at(step)`` as the loss's ``pld_theta`` each
microbatch when the ds_config ``progressive_layer_drop`` block is enabled,
and mirrors it in :class:`ProgressiveLayerDrop` after each step, as the JAX
engine does; both read the one schedule, ``theta_at``.
"""

from __future__ import annotations

import torch

from deepspeed_tpu_torch.utils.logging import log_dist


def theta_at(global_step, theta: float, gamma: float) -> float:
    """θ(t) = (1 - θ̄) · exp(-γ t) + θ̄, evaluated in fp32 as the JAX
    ``theta_at`` is, returned as a float."""
    t = torch.tensor(float(global_step), dtype=torch.float32)
    return float((1.0 - theta) * torch.exp(-gamma * t) + theta)


def layer_keep_probs(theta, n_layer: int, device=None) -> torch.Tensor:
    """(L,) fp32 keep probabilities ``p_l = 1 - (l+1)/L · (1 - θ)``: the
    first block kept with probability close to 1, the last with θ."""
    depth = (torch.arange(n_layer, dtype=torch.float32, device=device) + 1.0) / n_layer
    return 1.0 - depth * (1.0 - torch.as_tensor(theta, dtype=torch.float32, device=device))


class ProgressiveLayerDrop:
    """The host-side schedule object, the reference's API (``get_state`` /
    ``get_theta`` / ``update_state``)."""

    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = float(theta)
        self.gamma = float(gamma)
        self.current_theta = 1.0
        log_dist(f"Enabled progressive layer dropping (theta = {self.theta})", ranks=[0])

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self) -> float:
        return self.current_theta

    def update_state(self, global_step: int):
        self.current_theta = theta_at(global_step, self.theta, self.gamma)
