"""Block-wise Hessian eigenvalue estimation (power iteration).

Counterpart of ``deepspeed_tpu/runtime/eigenvalue.py`` (the reference's
``runtime/eigenvalue.py``): the top eigenvalue of each transformer layer's
diagonal block of the loss Hessian, normalized to [0, 1], which MoQ uses to
stretch each layer's quantization-period schedule (``1 + floor(4 ev)``: a
sharp layer anneals its precision more slowly).

The Hessian-vector product is double backward, the reference's way: one
forward and one ``create_graph`` backward per estimate, then each product
``H_ll v = d(g_l . v) / dθ_l`` is a backward through that backward
(``torch.autograd.grad(g_l, θ_l, grad_outputs=v)``), for every layer from
the same graph. The JAX package takes ``jax.jvp`` of ``jax.grad`` instead;
``torch.func.jvp`` over ``torch.func.grad`` would re-run the forward for
every product and needs the model as a pure function of its parameters,
which the engine's models are not. Neither transform goes through the
flash kernels (they have no double backward or jvp rule), so the loss must
run with the plain attention and no recompute: the engine passes one built
under ``models.common.plain_math``, and an estimate launches no kernel.

Power iteration per layer, as JAX: a normalized start vector (drawn from
``generator``, or given), ``Hv`` with NaN and infinities set to 0, the
Rayleigh quotient as the estimate, ``v = Hv / (|Hv| + stability)``, until
``max_iter`` products or a relative change below ``tol``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import log_dist


def _layers(params: Mapping[str, torch.Tensor], layer_name: str) -> List[Dict[str, torch.Tensor]]:
    """``params`` of the layer list ``layer_name`` per layer, each keyed by
    its name inside the layer, in layer order; [] when there is none."""
    layers: Dict[int, Dict[str, torch.Tensor]] = {}
    prefix = layer_name + "."
    for name, p in params.items():
        if not name.startswith(prefix):
            continue
        idx, _, key = name[len(prefix):].partition(".")
        if idx.isdigit() and key:
            layers.setdefault(int(idx), {})[key] = p
    return [layers[i] for i in sorted(layers)]


def _dot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> torch.Tensor:
    return sum(torch.vdot(x.float().reshape(-1), y.float().reshape(-1)) for x, y in zip(a, b))


def _norm(a: Sequence[torch.Tensor], stability: float) -> torch.Tensor:
    return torch.sqrt(_dot(a, a)) + stability


def block_eigenvalues(loss_fn: Callable[[], torch.Tensor], params: Mapping[str, torch.Tensor],
                      layer_name: str = "blocks", max_iter: int = 100, tol: float = 1e-2,
                      stability: float = 1e-6, generator: Optional[torch.Generator] = None,
                      v0: Optional[Sequence[Mapping[str, torch.Tensor]]] = None) -> torch.Tensor:
    """(L,) fp32 top eigenvalue of each layer's diagonal Hessian block.

    ``params``: the model's parameters by name (``blocks.{l}.{key}``, each
    requiring grad); ``loss_fn()``: the scalar loss, computed from them.
    ``v0``: per layer, the start vector by key (any scale: it is
    normalized), e.g. the JAX package's draws; else normal draws from
    ``generator``, the keys in sorted order as JAX's dict leaves."""
    layers = _layers(params, layer_name)
    if not layers:
        raise ValueError(f"no {layer_name!r} layers among the parameters")
    keys = [sorted(layer) for layer in layers]
    flat = [layer[k] for layer, ks in zip(layers, keys) for k in ks]
    grads = torch.autograd.grad(loss_fn(), flat, create_graph=True)
    evs = []
    at = 0
    for li, (layer, ks) in enumerate(zip(layers, keys)):
        ps = [layer[k] for k in ks]
        gs = grads[at:at + len(ks)]
        at += len(ks)
        if v0 is not None:
            v = [torch.as_tensor(np.array(v0[li][k]), dtype=torch.float32).to(p.device)
                 for k, p in zip(ks, ps)]
        else:
            v = [torch.randn(p.shape, generator=generator, dtype=torch.float32,
                             device=generator.device if generator is not None else p.device
                             ).to(p.device) for p in ps]
        n = _norm(v, stability)
        v = [x / n for x in v]
        i = 0
        ev = torch.tensor(1.0, dtype=torch.float32, device=ps[0].device)
        ev_prev = torch.tensor(0.0, dtype=torch.float32, device=ps[0].device)
        while True:
            rel = torch.abs((ev - ev_prev) / torch.where(ev == 0.0, torch.ones_like(ev), ev))
            if not (i < max_iter and bool(torch.abs(ev) > 0.0) and bool(rel >= tol)):
                break
            # a gradient that does not depend on the parameters adds nothing
            live = [j for j, g in enumerate(gs) if g.requires_grad]
            hv = torch.autograd.grad([gs[j] for j in live], ps,
                                     grad_outputs=[v[j].to(ps[j].dtype) for j in live],
                                     retain_graph=True, allow_unused=True)
            hv = [torch.zeros(p.shape, device=p.device) if h is None else
                  torch.nan_to_num(h.float(), nan=0.0, posinf=0.0, neginf=0.0)
                  for h, p in zip(hv, ps)]
            ev_prev, ev = ev, _dot(hv, v)
            n = _norm(hv, stability)
            v = [h / n for h in hv]
            i += 1
        evs.append(ev.detach())
    return torch.stack(evs)


def post_process(evs: torch.Tensor) -> torch.Tensor:
    """Normalize to [0, 1] by the largest |eigenvalue|; a layer that gave
    exactly 0 gets 1.0 (quantized the slowest, the conservative choice)."""
    mx = torch.max(torch.abs(evs))
    safe = torch.abs(evs) / torch.where(mx == 0.0, torch.ones_like(mx), mx)
    return torch.where(evs == 0.0, torch.ones_like(evs), safe)


class Eigenvalue:
    """The reference surface (``compute_eigenvalue`` and the block's
    knobs)."""

    def __init__(self, verbose: bool = False, max_iter: int = 100, tol: float = 1e-2,
                 stability: float = 1e-6, gas_boundary_resolution: int = 1,
                 layer_name: str = "blocks", layer_num: int = 0):
        self.verbose = verbose
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.stability = float(stability)
        self.gas_boundary_resolution = int(gas_boundary_resolution)
        self.layer_name = layer_name
        self.layer_num = int(layer_num)
        log_dist(f"enabled eigenvalue with verbose={verbose}, max_iter={max_iter}, "
                 f"tol={tol}, stability={stability}, "
                 f"gas_boundary_resolution={gas_boundary_resolution}, "
                 f"layer_name={layer_name}, layer_num={layer_num}", ranks=[0])

    def compute_eigenvalue(self, loss_fn: Callable[[], torch.Tensor],
                           params: Mapping[str, torch.Tensor],
                           generator: Optional[torch.Generator] = None,
                           v0=None) -> Dict[int, tuple]:
        """→ {layer: (normalized eigenvalue, layer)}, the reference's
        ev_dict keyed by layer index; {} when the model has no
        ``layer_name`` list."""
        if not _layers(params, self.layer_name):
            log_dist("The model does NOT support eigenvalue computation "
                     f"(no {self.layer_name!r} layers).", ranks=[0])
            return {}
        evs = post_process(block_eigenvalues(
            loss_fn, params, layer_name=self.layer_name, max_iter=self.max_iter, tol=self.tol,
            stability=self.stability, generator=generator, v0=v0)).cpu()
        if self.layer_num and len(evs) != self.layer_num:
            raise ValueError(f"eigenvalue.layer_num={self.layer_num} but "
                             f"{self.layer_name!r} has {len(evs)} layers")
        if self.verbose:
            log_dist(f"block eigenvalues (normalized): "
                     f"{[round(float(e), 4) for e in evs]}", ranks=[0])
        return {i: (float(e), i) for i, e in enumerate(evs)}
