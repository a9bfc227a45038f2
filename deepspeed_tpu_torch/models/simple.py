"""A tiny synthetic model for tests: a Linear → ReLU stack with an MSE head.

Counterpart of ``deepspeed_tpu/models/simple.py`` (the reference's
tests/unit/simple_model.py ``SimpleModel``). A batch is ``(x, y)``; the
weights keep the JAX orientation (``h @ w``), so :func:`params_from_jax`
copies them exactly. It trains under ``initialize`` on the engine's model
protocol (``loss``, ``init_params``). ``SimpleTPModel`` (tensor-parallel
specs) waits for model parallelism in the port.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.common import GatheredModule, assemble, init_pieces, meta_weight


class SimpleLayer(nn.Module):
    def __init__(self, hidden_dim: int):
        super().__init__()
        self.w = meta_weight(hidden_dim, hidden_dim)
        self.b = meta_weight(hidden_dim)


class SimpleModel(GatheredModule):
    """Linear → relu stack with an MSE head. batch = (x, y). Each layer
    computes through ``_gathered`` (ZeRO stage 3, compression); the JAX
    package keeps its layers as a list, not a stacked leaf."""

    stacked_layers = ()

    def __init__(self, hidden_dim: int = 16, nlayers: int = 2, empty_grad: bool = False):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.nlayers = nlayers
        self.empty_grad = empty_grad
        self.layers = nn.ModuleList(SimpleLayer(hidden_dim) for _ in range(nlayers))

    def init_params(self, generator: torch.Generator) -> "SimpleModel":
        """Normal 0.1 weights and zero biases from ``generator`` on its
        device, as the JAX package draws them. Returns self."""
        pieces = init_pieces(generator)
        h = self.hidden_dim

        def chunks():
            for i in range(self.nlayers):
                yield from pieces(f"layers.{i}.w", (h, h), 0.1)
                yield from pieces(f"layers.{i}.b", (h,))

        return assemble(self, chunks())

    def apply(self, x):
        h = x
        for i, layer in enumerate(self.layers):
            with self._gathered(layer) as lyr:
                h = h @ lyr.w.to(h.dtype) + lyr.b.to(h.dtype)
            if i < self.nlayers - 1:
                h = F.relu(h)
        return h

    forward = apply

    def loss(self, batch):
        x, y = batch
        pred = self.apply(x)
        return torch.mean(torch.square(pred - y.to(pred.dtype))).float()


def random_dataset(n_samples: int, hidden_dim: int, seed: int = 0):
    """Host-side (x, y) sample list, the JAX package's numpy draws."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n_samples, hidden_dim)).astype("float32")
    ys = rng.normal(size=(n_samples, hidden_dim)).astype("float32")
    return [(xs[i], ys[i]) for i in range(n_samples)]


def params_from_jax(np_params: Mapping[str, Any], hidden_dim: int, nlayers: int) -> SimpleModel:
    """A SimpleModel holding the JAX package's ``{"layers": [{"w", "b"}]}``
    tree, as numpy arrays; the copy is exact."""
    model = SimpleModel(hidden_dim, nlayers)
    sd = {f"layers.{i}.{k}": torch.tensor(np.asarray(lyr[k]))
          for i, lyr in enumerate(np_params["layers"]) for k in ("w", "b")}
    model.load_state_dict(sd, assign=True)
    return model
