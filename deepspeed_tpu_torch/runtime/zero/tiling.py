"""TiledLinear: a large linear layer computed one weight tile at a time.

Counterpart of ``deepspeed_tpu/runtime/zero/tiling.py`` (the reference's
``zero/tiling.py`` ``TiledLinear``, which splits a huge Linear into a grid
of smaller ones so ZeRO-3 can fetch and release each tile's weights
separately). :func:`tiled_matmul` walks the (in_splits × out_splits) grid
of ``w``'s tiles and adds each tile's product into an fp32 accumulator, so
one tile's product is alive at a time, as the JAX ``lax.scan`` over tiles
does; the products are ``torch.matmul``, as the JAX ones are plain XLA dots.
:class:`TiledLinear` is an ``nn.Module`` holding ``w`` (in, out) and ``b``
in the JAX orientation (``y = x @ w + b``).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def tiled_matmul(x: torch.Tensor, w: torch.Tensor, out_splits: int = 1,
                 in_splits: int = 1) -> torch.Tensor:
    """``x`` (..., K) @ ``w`` (K, N) over an (in_splits × out_splits) grid
    of tiles, accumulated in fp32, in ``x``'s type."""
    K, N = w.shape
    if K % in_splits or N % out_splits:
        raise ValueError(f"weight {tuple(w.shape)} does not split into {in_splits} x "
                         f"{out_splits} tiles")
    kt, nt = K // in_splits, N // out_splits
    acc = torch.zeros(x.shape[:-1] + (N,), dtype=torch.float32, device=x.device)
    for i in range(in_splits):
        xs = x[..., i * kt:(i + 1) * kt]
        for j in range(out_splits):
            tile = w[i * kt:(i + 1) * kt, j * nt:(j + 1) * nt]
            acc[..., j * nt:(j + 1) * nt] += (xs @ tile.to(xs.dtype)).float()
    return acc.to(x.dtype)


class TiledLinear(nn.Module):
    """``y = x @ w + b`` evaluated tile by tile (the reference's
    ``in_splits`` / ``out_splits``; ``input_is_already_split`` and the
    other keyword arguments of the reference are accepted and unused, as in
    the JAX package)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 in_splits: int = 1, out_splits: int = 1, **unused):
        super().__init__()
        if in_features % in_splits or out_features % out_splits:
            raise ValueError(f"({in_features}, {out_features}) does not split into "
                             f"{in_splits} x {out_splits} tiles")
        self.in_features, self.out_features = in_features, out_features
        self.in_splits, self.out_splits = in_splits, out_splits
        self.w = nn.Parameter(torch.empty(in_features, out_features))
        self.b = nn.Parameter(torch.zeros(out_features)) if bias else None

    def init_params(self, generator: torch.Generator) -> "TiledLinear":
        """Normal weights scaled by 1/sqrt(in_features), zero bias, drawn
        from ``generator``. Returns self."""
        with torch.no_grad():
            self.w.copy_(torch.randn(self.w.shape, generator=generator,
                                     device=generator.device) / math.sqrt(self.in_features))
            if self.b is not None:
                self.b.zero_()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = tiled_matmul(x, self.w, out_splits=self.out_splits, in_splits=self.in_splits)
        return y if self.b is None else y + self.b.to(y.dtype)

    apply = forward
