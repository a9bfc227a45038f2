"""Mixture-of-Experts gating, dispatch and combine.

Counterpart of ``deepspeed_tpu/moe/sharded_moe.py`` (the reference's
``deepspeed/moe/sharded_moe.py``): ``_capacity``, the compact top-1 and
top-2 routes and their dense ``(T, E, C)`` views, :class:`TopKGate` and
:class:`MOELayer` (dispatch into expert slots, the experts, gather by slot,
with a sentinel slot that absorbs dropped tokens), the same formulas.

The JAX engine runs a step as one program over the global micro-batch, so
its gate routes every token of every rank together. Here each rank runs
its own tokens, and with a process group (``utils/groups.ExpertGroups``
of more than one rank) the gate computes what that one program computes:

* each rank's expert choices are all-gathered over the world and laid out
  in the global micro-batch's token order: the engine's loader gives rank
  ``r`` rows ``r::world``, so global row ``i`` is local row ``i // W`` of
  rank ``i % W``, and token ``(row, t)`` is ``row * T + t``;
* from that order every rank computes its tokens' places in their experts'
  global queues, the capacity of the global token count, which tokens
  drop, and ``ce`` (each expert's share of all tokens);
* ``l_aux``'s ``me`` is the rank's own gate mean: the engine averages the
  ranks' losses, which makes the global ``E * sum(me * ce)``.

A rank's kept tokens on an expert are a prefix of its own tokens on it, so
it writes them into a static ``(E, C_r, D)`` buffer, ``C_r = min(C,
T_local)``; with one rank that is the JAX buffer (whose rows past ``T`` no
token could fill). The buffer goes to the experts' owners over the
expert-parallel group with ``all_to_all_single`` (:class:`_AllToAll`, whose
backward is the same exchange), equal splits and no host sync; the owner
runs its ``E / ep`` experts on ``(E / ep, ep * C_r, D)`` and the return
exchange brings the outputs back for the combine. With one rank no
collective runs, as the JAX program has none at ``expert`` 1.

Every slot but the sentinel receives at most one token, so dispatch (a
copy into slots, whose backward is a gather) and combine (a gather, whose
backward adds into distinct slots) do not depend on the order of atomic
adds, the sentinel's row aside, which is discarded; capacities are host integers of static shapes and nothing reads a
count back to the host, so the layer can be captured in a CUDA graph.
The layer's four parts run under ``torch.profiler.record_function``
ranges (``moe_gate``, ``moe_dispatch``, ``moe_experts``, ``moe_combine``),
so a trace can attribute device time to them; with ``record`` set, a call
keeps its routing (:attr:`MOELayer.routing`, device tensors, no host sync),
and with ``pinned`` set to such a routing a call routes as it did
(:func:`pinned_route`): a comparison of two numerical paths of a model
(the attention kernels against their plain versions) then holds their
continuous difference apart from the tokens their roundings send to other
experts.
Random draws (top-2's random second-expert keep, ``RSample`` noise) come
from a ``torch.Generator`` over the global token count, each rank taking
its own tokens' draws; they cannot equal JAX's draws bit for bit.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models.common import meta_weight


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int) -> int:
    """Tokens each expert may take (reference ``_capacity``)."""
    return max(int(math.ceil(num_tokens / num_experts * capacity_factor)), min_capacity)


def _one_hot(idx, num: int):
    """fp32 one-hot by comparison (no range check, so no host sync); an
    index outside [0, num) gives a zero row."""
    return (idx[..., None] == torch.arange(num, device=idx.device)).float()


class TokenOrder:
    """The global micro-batch's token order over a group of ``world`` ranks,
    each holding ``rows`` rows of ``tokens // rows`` tokens: rank ``r``'s
    local row ``b`` is global row ``b * world + r``."""

    def __init__(self, group, world: int, rank: int, rows: int, tokens: int):
        self.group, self.world, self.rank = group, world, rank
        self.rows, self.per_row = rows, tokens // rows

    @property
    def tokens(self) -> int:
        return self.world * self.rows * self.per_row

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's (T_local, ...) values, every rank's, in global order."""
        if self.group is None:
            return t
        t = t.contiguous()
        out = t.new_empty((self.world * t.shape[0],) + tuple(t.shape[1:]))
        comm.all_gather_into_tensor(out, t, group=self.group)
        out = out.view(self.world, self.rows, self.per_row, *t.shape[1:]).transpose(0, 1)
        return out.reshape(self.tokens, *t.shape[1:])

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's tokens of a (T_global, ...) tensor in global order."""
        if self.group is None:
            return t
        rest = t.shape[1:]
        t = t.view(self.rows, self.world, self.per_row, *rest)[:, self.rank]
        return t.reshape(self.rows * self.per_row, *rest)


def _queue_places(mask):
    """Each token's place in its expert's queue: the exclusive cumulative
    sum of a (T, E) one-hot over the tokens, scanned along the last axis of
    its (E, T) transpose (a scan over the outer axis of eight columns runs
    on few threads)."""
    counts = torch.cumsum(mask.t().contiguous(), dim=1).t()
    return counts - mask


def _local_order(tokens: int) -> TokenOrder:
    return TokenOrder(None, 1, 0, tokens, tokens)


def _draw_uniform(generator, shape, device):
    return torch.rand(shape, generator=generator, device=device)


def _draw_gumbel(generator, shape, device):
    u = torch.rand(shape, generator=generator, device=device).clamp_(min=torch.finfo(
        torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _top1_route(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
                noisy_gate_policy: Optional[str] = None, generator=None,
                drop_tokens: bool = True, capacity: Optional[int] = None,
                order: Optional[TokenOrder] = None, noise=None):
    """Switch-style top-1 routing in compact form: (l_aux, expert index
    (T, 1), slot (T, 1), weight (T, 1), 0 for a dropped token, capacity C).
    The slot is the token's place in its expert's queue (with a group, in
    this rank's part of it, below ``min(C, T_local)``). ``noise``: the
    ``RSample`` Gumbel noise over the global tokens, drawn from
    ``generator`` when not given."""
    T, E = logits.shape
    order = order or _local_order(T)
    if capacity is None:
        # without drops the static worst case: every token on one expert
        capacity = _capacity(order.tokens, E, capacity_factor, min_capacity) \
            if drop_tokens else order.tokens
    gates = torch.softmax(logits, dim=1)
    if noisy_gate_policy == "RSample" and (noise is not None or generator is not None):
        if noise is None:
            noise = _draw_gumbel(generator, (order.tokens, E), logits.device)
        indices1 = torch.argmax(logits + order.local(noise), dim=1)
    else:
        indices1 = torch.argmax(gates, dim=1)
    mask1_local = _one_hot(indices1, E)                        # (T, E)
    mask1 = _one_hot(order.gather(indices1.int()), E)          # (T_global, E)

    # load-balance loss: the rank's mean gate, every token's expert share
    me = torch.mean(gates, dim=0)
    ce = torch.mean(mask1, dim=0)
    l_aux = torch.sum(me * ce) * E

    # places in the global queues decide the drops; the rank's own slots
    # are its places among its own tokens
    if drop_tokens:
        locations1 = _queue_places(mask1)
        mask1_local = mask1_local * order.local((locations1 < capacity).float() * mask1)
    slots = _queue_places(mask1_local) * mask1_local
    kept = torch.sum(mask1_local, dim=1) > 0
    pos1 = torch.sum(slots, dim=1).int()
    weight = torch.sum(gates * mask1_local, dim=1) * kept
    return l_aux, indices1.int()[:, None], pos1[:, None], weight[:, None], capacity


def _dense_from_route(expert_idx, pos, weight, num_experts: int, capacity: int):
    """Compact route → dense (T, E, C) combine weights and dispatch mask."""
    combine = torch.zeros((expert_idx.shape[0], num_experts, capacity), dtype=torch.float32,
                          device=expert_idx.device)
    for k in range(expert_idx.shape[1]):
        combine = combine + (weight[:, k, None, None]
                             * _one_hot(expert_idx[:, k], num_experts)[:, :, None]
                             * _one_hot(pos[:, k], capacity)[:, None, :])
    return combine, combine > 0


def top1gating(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
               noisy_gate_policy: Optional[str] = None, generator=None,
               drop_tokens: bool = True, capacity: Optional[int] = None):
    """The reference-shaped surface: (l_aux, combine (T, E, C), dispatch,
    capacity)."""
    l_aux, eidx, pos, w, capacity = _top1_route(logits, capacity_factor, min_capacity,
                                                noisy_gate_policy, generator, drop_tokens,
                                                capacity)
    combine, dispatch = _dense_from_route(eidx, pos, w, logits.shape[1], capacity)
    return l_aux, combine, dispatch, capacity


def _top2_route(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
                drop_tokens: bool = True, generator=None, second_policy: str = "random",
                capacity: Optional[int] = None, order: Optional[TokenOrder] = None,
                noise=None):
    """GShard top-2 routing in compact form: the second expert kept with
    probability twice its gate (``second_policy="random"`` with a
    ``generator`` or ``noise``, the uniform draws over the global tokens),
    the capacity doubled, second choices queued after every first choice.
    → (l_aux, expert index (T, 2), slot (T, 2), weight (T, 2), C)."""
    T, E = logits.shape
    order = order or _local_order(T)
    if capacity is None:
        # a token's two choices differ, so no expert holds more than T
        capacity = _capacity(order.tokens, E, 2 * capacity_factor, min_capacity) \
            if drop_tokens else order.tokens
    gates = torch.softmax(logits, dim=1)
    indices1 = torch.argmax(gates, dim=1)
    mask1_local = _one_hot(indices1, E)
    indices2 = torch.argmax(gates * (1 - mask1_local), dim=1)
    mask2_local = _one_hot(indices2, E)
    if second_policy == "random" and (noise is not None or generator is not None):
        if noise is None:
            noise = _draw_uniform(generator, (order.tokens,), logits.device)
        gate2 = torch.sum(gates * mask2_local, dim=1)
        mask2_local = mask2_local * (order.local(noise) < 2 * gate2)[:, None]

    # a second choice not kept travels as expert E: a zero row
    second = torch.where(mask2_local.sum(dim=1) > 0, indices2, E)
    both = order.gather(torch.stack([indices1, second], dim=1).int())
    mask1, mask2 = _one_hot(both[:, 0], E), _one_hot(both[:, 1], E)

    me = torch.mean(gates, dim=0)
    ce = torch.mean(mask1, dim=0)
    l_aux = torch.sum(me * ce) * E

    if drop_tokens:
        locations1 = _queue_places(mask1)
        locations2 = _queue_places(mask2) + torch.sum(mask1, dim=0, keepdim=True)
        firsts = mask1_local.sum(dim=0, keepdim=True)       # before the drops
        mask1_local = mask1_local * order.local((locations1 < capacity).float() * mask1)
        mask2_local = mask2_local * order.local((locations2 < capacity).float() * mask2)
    else:
        firsts = mask1_local.sum(dim=0, keepdim=True)
    # a kept second choice finds every first choice of its expert kept, so
    # the rank's first choices on it come before it
    slots1 = _queue_places(mask1_local) * mask1_local
    slots2 = (_queue_places(mask2_local) + firsts) * mask2_local
    kept1 = torch.sum(mask1_local, dim=1) > 0
    kept2 = torch.sum(mask2_local, dim=1) > 0
    pos = torch.stack([slots1.sum(dim=1), slots2.sum(dim=1)], dim=1).int()
    gates1 = torch.sum(gates * mask1_local, dim=1)
    gates2 = torch.sum(gates * mask2_local, dim=1)
    denom = torch.clamp(gates1 + gates2, min=1e-9)
    weight = torch.stack([gates1 / denom * kept1, gates2 / denom * kept2], dim=1)
    expert_idx = torch.stack([indices1, indices2], dim=1).int()
    return l_aux, expert_idx, pos, weight, capacity


def top2gating(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
               drop_tokens: bool = True, generator=None, second_policy: str = "random",
               capacity: Optional[int] = None):
    """The reference-shaped surface: (l_aux, combine (T, E, C), dispatch,
    capacity)."""
    l_aux, eidx, pos, w, capacity = _top2_route(logits, capacity_factor, min_capacity,
                                                drop_tokens, generator, second_policy,
                                                capacity)
    combine, dispatch = _dense_from_route(eidx, pos, w, logits.shape[1], capacity)
    return l_aux, combine, dispatch, capacity


@contextlib.contextmanager
def own_weights(module):
    """A module's own parameters to compute with (``_gathered``'s role when
    no engine gathers them)."""
    yield module


class TopKGate(nn.Module):
    """The gate: a (D, E) projection in fp32 and top-k routing."""

    def __init__(self, model_dim: int, num_experts: int, k: int = 1,
                 capacity_factor: float = 1.0, eval_capacity_factor: float = 1.0,
                 min_capacity: int = 4, noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True):
        super().__init__()
        if k not in (1, 2):
            raise ValueError(f"top-{k} gating: only top-1 and top-2 (as the reference)")
        self.model_dim, self.num_experts, self.k = model_dim, num_experts, k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens = drop_tokens
        self.wg = meta_weight(model_dim, num_experts)

    def param_chunks(self, pieces, prefix: str):
        yield from pieces(f"{prefix}wg", (self.model_dim, self.num_experts),
                          1.0 / math.sqrt(self.model_dim))

    def draws(self, generator, tokens: int, device, train: bool = True):
        """The random draws a routing of ``tokens`` global tokens takes
        (None when it takes none)."""
        if generator is None or not train:
            return None
        if self.k == 2:
            return _draw_uniform(generator, (tokens,), device)
        if self.noisy_gate_policy == "RSample":
            return _draw_gumbel(generator, (tokens, self.num_experts), device)
        return None

    def route(self, x, train: bool = True, generator=None, order=None, noise=None,
              wg=None):
        """x (T, D) → (l_aux, expert index (T, k), slot (T, k), weight (T, k),
        capacity C); ``wg``: the gathered weight (the module's own by
        default)."""
        wg = self.wg if wg is None else wg
        logits = x.float() @ wg.float()
        cf = self.capacity_factor if train else self.eval_capacity_factor
        if not train:
            generator = noise = None
        if self.k == 1:
            return _top1_route(logits, cf, self.min_capacity,
                               self.noisy_gate_policy if train else None, generator,
                               self.drop_tokens, order=order, noise=noise)
        return _top2_route(logits, cf, self.min_capacity, self.drop_tokens, generator,
                           order=order, noise=noise)

    def forward(self, x, train: bool = True, generator=None):
        """x (T, D) → (l_aux, combine (T, E, C), dispatch (T, E, C)): the
        reference-shaped dense view."""
        l_aux, eidx, pos, w, capacity = self.route(x, train, generator)
        combine, dispatch = _dense_from_route(eidx, pos, w, self.num_experts, capacity)
        return l_aux, combine, dispatch


def pinned_route(gate: TopKGate, x, routing: dict, wg=None):
    """The route of ``x`` (T, D) with a recorded routing's discrete choices
    (experts, slots, kept tokens and capacity) weighed by this gate's own
    softmax, through which the gradient flows; ``l_aux`` from its own gate
    mean and the recorded first choices' shares."""
    gates = torch.softmax(x.float() @ (gate.wg if wg is None else wg).float(), dim=1)
    E = gate.num_experts
    mask = _one_hot(routing["experts"].long(), E)                     # (T, k, E)
    l_aux = torch.sum(gates.mean(dim=0) * mask[:, 0].mean(dim=0)) * E
    w = torch.sum(gates[:, None] * mask, dim=2) * (routing["weights"] > 0)
    if w.shape[1] == 2:
        w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-9)
    return l_aux, routing["experts"], routing["positions"], w, routing["capacity"]


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``group`` with equal splits; its backward
    is the same exchange of the gradients (reference ``_AllToAll``)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        comm.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return None, _AllToAll.apply(ctx.group, grad)


class MOELayer:
    """Dispatch → experts → combine (reference ``MOELayer``). It holds
    references to its gate and experts, which the owning module registers."""

    def __init__(self, gate: TopKGate, experts: nn.Module, num_experts: int):
        self.gate = gate
        self.experts = experts
        self.num_experts = num_experts
        # set ``record`` to keep each call's routing in ``routing``: the
        # experts, slots and weights (T, k), l_aux and the capacities
        self.record = False
        self.routing: Optional[dict] = None
        # a recorded routing to route as (pinned_route); None: the gate's own
        self.pinned: Optional[dict] = None

    def __call__(self, x, train: bool = True, generator=None, groups=None, noise=None,
                 gathered: Callable = own_weights):
        """x (..., D) → (out (..., D), l_aux). ``groups``: the engine's
        ``ExpertGroups`` (None: this process alone); ``noise``: the gate's
        draws (``TopKGate.draws``), drawn from ``generator`` when not
        given; ``gathered``: the context that gives a module's weights to
        compute with (the model's ``_gathered`` under ZeRO stage 3)."""
        shape, D = x.shape, x.shape[-1]
        tokens = x.reshape(-1, D)
        T = tokens.shape[0]
        rows = shape[0] if x.dim() > 2 else T
        world = 1 if groups is None else groups.world
        order = TokenOrder(groups.world_group if world > 1 else None, world,
                           0 if groups is None else groups.rank, rows, T) if world > 1 \
            else _local_order(T)
        with record_function("moe_gate"), gathered(self.gate) as g:
            if self.pinned is not None:
                l_aux, eidx, pos, w, C = pinned_route(self.gate, tokens, self.pinned, g.wg)
            else:
                l_aux, eidx, pos, w, C = self.gate.route(tokens, train, generator, order,
                                                         noise, wg=g.wg)
        E, k = self.num_experts, eidx.shape[1]
        cap = min(C, T)                       # this rank's slots per expert
        if self.record:
            self.routing = {"experts": eidx.detach(), "positions": pos.detach(),
                            "weights": w.detach(), "l_aux": l_aux.detach(), "capacity": C,
                            "slots": cap}
        ep = 1 if groups is None else groups.ep_size
        with record_function("moe_dispatch"):
            slot = torch.where(w > 0, eidx.long() * cap + pos.long(), E * cap).reshape(-1)
            # each kept (token, choice) copied to its slot, the dropped ones
            # to the sentinel row; the backward is a gather by slot
            dispatched = tokens.new_zeros(E * cap + 1, D).index_copy(
                0, slot, tokens[:, None].expand(T, k, D).reshape(T * k, D))
            dispatched = dispatched[:-1].view(E, cap, D)
            if ep > 1:
                # the dispatch all-to-all: expert block j to expert rank j
                dispatched = _AllToAll.apply(groups.ep_group, dispatched)
                dispatched = dispatched.view(ep, E // ep, cap, D).transpose(0, 1) \
                    .reshape(E // ep, ep * cap, D)
        with record_function("moe_experts"), gathered(self.experts) as ew:
            expert_out = self.experts(dispatched, ew)
        with record_function("moe_combine"):
            if ep > 1:
                expert_out = expert_out.view(E // ep, ep, cap, D).transpose(0, 1) \
                    .reshape(E, cap, D)
                expert_out = _AllToAll.apply(groups.ep_group, expert_out)
            eflat = torch.cat([expert_out.reshape(E * cap, D), expert_out.new_zeros(1, D)],
                              dim=0)
            picked = eflat.index_select(0, slot).view(T, k, D)
            out = torch.sum(w[..., None].to(x.dtype) * picked, dim=1)
        return out.reshape(shape), l_aux


def gelu_tanh(h):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(h, approximate="tanh")
