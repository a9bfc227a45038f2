"""Data routing: random layer token dropping (random-LTD).

Counterpart of ``deepspeed_tpu/runtime/data_pipeline/data_routing.py``
(reference ``data_pipeline/data_routing``: ``scheduler.py``
``RandomLTDScheduler``, ``basic_layer.py`` and the gather/scatter of
``csrc/random_ltd``). Middle transformer layers train on a random subset of
the tokens, the kept count ramping from ``min_value`` to ``max_value`` on a
fixed_linear schedule. The gather and scatter are indexing ops on the
device. As in the JAX engine, the ds_config ``data_efficiency.data_routing``
block is accepted and applied to no model: a client calls these ops.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


class RandomLTDScheduler:
    """The kept-token ramp and the consumed layer-token count (reference
    ``scheduler.py``).

    config: {total_layer_num, random_ltd_layer_num, global_batch_size,
             schedule: {min_value, max_value, schedule_type,
                        schedule_config: {require_steps, seq_per_step}}}
    """

    def __init__(self, config: Dict):
        self.model_layer_num = int(config["total_layer_num"])
        self.random_ltd_layer_num = int(config["random_ltd_layer_num"])
        self.global_batch_size = int(config.get("global_batch_size", 1))
        sched = config["schedule"]
        self.min_value = int(sched["min_value"])
        self.max_value = int(sched["max_value"])
        self.schedule_type = sched.get("schedule_type", "fixed_linear")
        sc = sched.get("schedule_config", {})
        self.require_steps = int(sc["require_steps"])
        self.seq_per_step = int(sc.get("seq_per_step", 8))
        self.current_value = self.min_value
        self.consumed_layer_tokens = 0
        self._last_step = -1

    def get_value(self, global_steps: int) -> int:
        """The kept count at ``global_steps``: the linear ramp, rounded down
        to a multiple of ``seq_per_step``, within [min_value, max_value]."""
        if self.schedule_type != "fixed_linear":
            raise RuntimeError("Unsupported random LTD schedule type")
        nxt = math.floor((float(global_steps) / self.require_steps)
                         * (self.max_value - self.min_value) + self.min_value)
        nxt -= nxt % self.seq_per_step
        return max(self.min_value, min(nxt, self.max_value))

    def update_seq(self, global_steps: int) -> int:
        """The kept count of a new step, its layer tokens counted once."""
        if global_steps != self._last_step:
            self.current_value = self.get_value(global_steps)
            self.consumed_layer_tokens += self.global_batch_size * (
                self.current_value * self.random_ltd_layer_num
                + self.max_value * (self.model_layer_num - self.random_ltd_layer_num))
            self._last_step = global_steps
        return self.current_value

    def get_current_seq(self) -> int:
        return self.current_value

    def get_random_ltd_layer_num(self) -> int:
        return self.random_ltd_layer_num

    def get_total_layer_tokens(self, train_iters: int) -> int:
        for step in range(train_iters):
            self.update_seq(step)
        return self.consumed_layer_tokens

    def state_dict(self) -> Dict:
        return {"current_value": self.current_value,
                "consumed_layer_tokens": self.consumed_layer_tokens}

    def load_state_dict(self, sd: Dict):
        self.current_value = int(sd["current_value"])
        self.consumed_layer_tokens = int(sd["consumed_layer_tokens"])


def random_ltd_sample(generator: torch.Generator, seq_len: int, kept: int,
                      batch: int) -> torch.Tensor:
    """(batch, kept) int64 token indices to keep, on ``generator``'s device:
    per sequence the first ``kept`` of a random permutation, sorted, so the
    kept tokens keep their order (the reference's token sort)."""
    dev = generator.device
    perms = torch.stack([torch.randperm(seq_len, generator=generator, device=dev)[:kept]
                         for _ in range(batch)])
    return torch.sort(perms, dim=1).values


def random_ltd_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, T, D) and (B, kept) → the kept tokens (B, kept, D) (the
    reference's ``gather_tokens``)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def random_ltd_scatter(x_small: torch.Tensor, idx: torch.Tensor,
                       x_full: torch.Tensor) -> torch.Tensor:
    """``x_full`` with the processed kept tokens ``x_small`` written back at
    ``idx``; the dropped positions keep ``x_full``'s values (the
    reference's ``scatter_tokens``). ``x_full`` is not modified."""
    return x_full.scatter(1, idx[..., None].expand(-1, -1, x_full.shape[-1]), x_small)
