"""The engine's ZeRO state: per-unit buffers, their collectives, stage-3 gathers.

The runtime half of ``partition.py``'s plan, in the reference DeepSpeed's
design (``zero/stage_1_and_2.py``, ``zero/stage3.py``) where the JAX
engine (``_apply_grads``) moves gradients and state to their placement with
one sharding constraint and lets XLA issue the collectives. Everything is
held per unit (one module's parameters, flat), and a step, a save or a load
allocates and moves one unit at a time beyond the state itself.

The optimizer updates one fp32 tensor per unit, ``fp32[u]``: the whole
unit at stage 0 (every rank keeps every master), the rank's shard at
stages 1–3.

Gradients: a post-accumulate hook on each whole parameter adds its
gradient (in ``grad_accum_dtype``) into its view of its unit's gradient
buffer, which is allocated at the unit's first gradient, so gradients
never accumulate in the compute type and no buffer exists before backward
reaches its unit; a stage-3 parameter's gradient arrives through its
gather's backward instead. Stages 0 and 1 keep the whole buffers until the
accumulation boundary, then all-reduce each (0), or reduce-scatter each
into the rank's shard and free it (1). Stages 2 and 3 reduce-scatter a
unit's buffer in every microbatch as soon as the unit's gradients are
complete (each of its parameters' hooks has run, or each gather of its
module in the forward has had its backward), add the shard into the rank's
gradient shard and free the buffer; a unit still pending when backward
ends is reduced then, in unit order. Every reduction averages over the
group.

Parameters: each parameter of a whole unit is a view of that unit's flat
compute-type buffer, refreshed after each applied step from the updated
fp32 values: a cast copy at stage 0, an all-gather of the cast shards
at stages 1–3. A stage-3 unit's parameters hold no storage: the rank keeps
its shard of the unit in the compute type, and ``gather(module)`` runs an
all-gather just before the module computes (an autograd Function whose
backward adds the gradients into the unit's buffer), ``release(module)``
after. Autograd would keep the gathered buffer alive until backward
wherever an op saves a weight, so while the engine runs a forward,
``saved_tensor_hooks`` replaces every saved view of a live gathered buffer
with a token, and backward gathers the unit again when it unpacks one
(keeping the last unit gathered in backward until another is asked for).
A block under activation checkpointing gathers again when it is recomputed.

Checkpoints: ``to_host`` copies whole per-parameter tensors to the host
one unit at a time, gathering each partitioned unit; ``load`` gives each
rank its part of whole tensors, one unit at a time.

Without a process group (one process, nothing initialized) the same
buffers are used and no collective is issued; with one, every collective
runs, a world of one included.
"""

from __future__ import annotations

import contextlib
import types
from typing import Dict, List, NamedTuple, Optional, Sequence, Union

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.runtime.zero.partition import ZeroPlan

# a source of whole tensors: the compute-type params, or per-unit tensors
# laid out as ZeroState.fp32 (the masters, an optimizer moment, gradients)
PARAMS = "params"
Source = Union[str, Sequence[torch.Tensor]]


class _Token(NamedTuple):
    """A saved view of a gathered unit, without its storage."""
    unit: int
    offset: int
    size: tuple
    stride: tuple


class _Gather(torch.autograd.Function):
    """A stage-3 unit's parameters, gathered whole; the gradients of the
    views go into the unit's gradient buffer, and none to the empty
    parameters."""

    @staticmethod
    def forward(ctx, state, unit, *params):
        ctx.state, ctx.unit = state, unit
        ctx.set_materialize_grads(False)
        return tuple(state._views(state._gather(unit, live=True), unit))

    @staticmethod
    def backward(ctx, *grads):
        ctx.state._accumulate(ctx.unit, grads)
        return (None, None) + (None,) * len(grads)


class ZeroState:
    """Per-unit buffers of one engine's parameters, gradients and the fp32
    values its optimizer updates, over the process group ``group`` (None:
    no collectives). ``fp32_values``: the whole fp32 value of each of
    ``params``; every rank starts from rank 0's."""

    def __init__(self, plan: ZeroPlan, params: Sequence[torch.nn.Parameter],
                 owners: Sequence[torch.nn.Module], fp32_values: Sequence[torch.Tensor],
                 dtype: torch.dtype, grad_dtype: torch.dtype, device: torch.device,
                 group=None, rank: int = 0):
        self.plan = plan
        self.params = list(params)
        self.stage = plan.stage
        self.sharded = self.stage >= 1
        self.group = group
        self.rank = rank
        self.dtype = dtype
        self.grad_dtype = grad_dtype
        self.device = device
        self.gathers = 0                        # stage-3 all-gathers issued
        self._grads: Dict[int, torch.Tensor] = {}        # unit -> whole gradient buffer
        self._shard_grads: Dict[int, torch.Tensor] = {}  # unit -> reduced shard (stages 2, 3)
        self._arrived: Dict[int, int] = {}      # unit -> gradient deliveries this backward
        self._due: Dict[int, int] = {}          # stage-3 unit -> its gathers this forward
        self._forwarding = False
        self._live: Dict[int, tuple] = {}       # storage ptr -> (unit, buffer)
        self._bwd: Optional[tuple] = None       # (unit, buffer) gathered in backward
        self._unit_of: Dict[int, int] = {}      # id(module) -> stage-3 unit
        self._names: Dict[int, List[str]] = {}  # id(module) -> its direct param names
        for m in {id(m): m for m in owners}.values():
            self._names[id(m)] = [n for n, p in m.named_parameters(recurse=False)
                                  if p.requires_grad]

        self.fp32: List[torch.Tensor] = []      # the optimizer's target, per unit
        self.whole: Dict[int, torch.Tensor] = {}   # compute-type buffer of a whole unit
        self.parts: Dict[int, torch.Tensor] = {}   # compute-type shard of a stage-3 unit
        with torch.no_grad():
            for u, unit in enumerate(plan.units):
                buf = torch.zeros(unit.length, dtype=torch.float32, device=device)
                for i in unit.params:
                    self._view(buf, i).copy_(fp32_values[i])
                if group is not None:
                    comm.broadcast(buf, src=0, group=group)
                self.fp32.append((self._shard(buf, u) if self.sharded else buf).clone())
                if unit.partitioned:
                    self.parts[u] = self._shard(buf, u).to(dtype, copy=True)
                    for i in unit.params:
                        self.params[i].data = torch.empty(0, dtype=dtype, device=device)
                        self._unit_of[id(owners[i])] = u
                else:
                    self.whole[u] = buf.to(dtype, copy=True)
                    for i in unit.params:
                        self.params[i].data = self._view(self.whole[u], i)
                del buf

    # ------------------------------------------------------------- layout
    def _view(self, unit_buf: torch.Tensor, i: int) -> torch.Tensor:
        p = self.plan.params[i]
        return unit_buf[p.offset:p.offset + p.numel].view(p.shape)

    def _views(self, unit_buf: torch.Tensor, u: int) -> List[torch.Tensor]:
        return [self._view(unit_buf, i) for i in self.plan.units[u].params]

    def _shard(self, unit_buf: torch.Tensor, u: int) -> torch.Tensor:
        n = self.plan.units[u].shard
        return unit_buf[self.rank * n:(self.rank + 1) * n]

    def segments(self):
        """(param index, unit, start, end) of each parameter's elements in
        ``fp32[unit]``."""
        if self.sharded:
            return self.plan.segments(self.rank)
        return [(i, p.unit, p.offset, p.offset + p.numel) for i, p in enumerate(self.plan.params)]

    # ---------------------------------------------------------- gradients
    def _buffer(self, u: int) -> torch.Tensor:
        buf = self._grads.get(u)
        if buf is None:
            buf = self._grads[u] = torch.zeros(self.plan.units[u].length, dtype=self.grad_dtype,
                                               device=self.device)
        return buf

    def grad_hook(self, i: int):
        """The post-accumulate hook of whole parameter ``i``."""
        u = self.plan.params[i].unit

        def hook(p):
            g, p.grad = p.grad, None
            self._view(self._buffer(u), i).add_(g)
            self._delivered(u)
        return hook

    def _accumulate(self, u: int, grads) -> None:
        buf = self._buffer(u)
        for i, g in zip(self.plan.units[u].params, grads):
            if g is not None:
                self._view(buf, i).add_(g)
        self._delivered(u)

    def _delivered(self, u: int) -> None:
        """One delivery into unit ``u``'s buffer; at stages 2 and 3 the
        unit is reduced once all of this backward's have come."""
        if self.stage < 2:
            return
        n = self._arrived[u] = self._arrived.get(u, 0) + 1
        unit = self.plan.units[u]
        if n >= (self._due.get(u, 0) if unit.partitioned else len(unit.params)):
            self._reduce(u)

    def _reduce(self, u: int) -> None:
        """Unit ``u``'s buffer, averaged over the group, added into the
        rank's gradient shard; the buffer freed."""
        buf = self._grads.pop(u)
        if self.group is None:
            part = buf
        else:
            part = torch.empty(self.plan.units[u].shard, dtype=buf.dtype, device=self.device)
            comm.reduce_scatter_tensor(part, buf, op=comm.ReduceOp.AVG, group=self.group)
        del buf
        have = self._shard_grads.get(u)
        if have is None:
            self._shard_grads[u] = part
        else:
            have.add_(part)

    def end_backward(self) -> None:
        self._bwd = None
        if self.stage >= 2:
            for u in sorted(self._grads):
                self._reduce(u)
        self._arrived.clear()
        self._due.clear()

    def reduced_grads(self, gas: int) -> List[torch.Tensor]:
        """The boundary: each unit's gradient, the mean over microbatches
        and ranks, laid out as ``fp32``. Every buffer is released."""
        units = self.plan.units
        if self.stage == 1:
            for u in range(len(units)):
                self._buffer(u)
                self._reduce(u)
        out = []
        for u, unit in enumerate(units):
            if self.stage == 0:
                g = self._grads.pop(u, None)
                if g is None:
                    g = torch.zeros(unit.length, dtype=self.grad_dtype, device=self.device)
                if self.group is not None:
                    comm.all_reduce(g, op=comm.ReduceOp.AVG, group=self.group)
            else:
                g = self._shard_grads.pop(u, None)
                if g is None:
                    g = torch.zeros(unit.shard, dtype=self.grad_dtype, device=self.device)
            if gas > 1:
                g.div_(gas)
            out.append(g)
        return out

    # ---------------------------------------------------- after the update
    @torch.no_grad()
    def refresh_params(self) -> None:
        """The compute-type params from the updated fp32 values."""
        for u, unit in enumerate(self.plan.units):
            if unit.partitioned:
                self.parts[u].copy_(self.fp32[u])
            elif not self.sharded or self.group is None:
                self.whole[u].copy_(self.fp32[u])
            else:
                comm.all_gather_into_tensor(self.whole[u], self.fp32[u].to(self.dtype),
                                            group=self.group)

    # ------------------------------------------------------- stage 3: gather
    def _gather(self, u: int, live: bool) -> torch.Tensor:
        unit = self.plan.units[u]
        buf = torch.empty(unit.length, dtype=self.dtype, device=self.device)
        if self.group is None:
            buf.copy_(self.parts[u])
        else:
            comm.all_gather_into_tensor(buf, self.parts[u], group=self.group)
        self.gathers += 1
        if live:
            self._live[buf.untyped_storage().data_ptr()] = (u, buf)
        return buf

    def gather(self, module: torch.nn.Module):
        """``module``'s own parameters as tensors to compute with: the
        gathered views of its stage-3 unit, the parameters themselves for
        the rest. Pair with :meth:`release`."""
        u = self._unit_of.get(id(module))
        if u is None:
            return module
        if self._forwarding and torch.is_grad_enabled():
            self._due[u] = self._due.get(u, 0) + 1
        params = [self.params[i] for i in self.plan.units[u].params]
        views = _Gather.apply(self, u, *params)
        if torch.is_tensor(views):
            views = (views,)
        gathered = {id(p): v for p, v in zip(params, views)}
        return types.SimpleNamespace(**{
            n: gathered.get(id(getattr(module, n)), getattr(module, n))
            for n in self._names[id(module)]})

    def release(self, module: torch.nn.Module) -> None:
        u = self._unit_of.get(id(module))
        for key, (unit, _) in list(self._live.items()):
            if unit == u:
                del self._live[key]

    def _pack(self, t: torch.Tensor):
        if not self._live:
            return t
        hit = self._live.get(t.untyped_storage().data_ptr())
        if hit is None:
            return t
        return _Token(hit[0], t.storage_offset(), tuple(t.shape), t.stride())

    def _unpack(self, x):
        if not isinstance(x, _Token):
            return x
        if self._bwd is None or self._bwd[0] != x.unit:
            # drop the previous unit before gathering the next; the views
            # autograd already unpacked keep it for as long as they need it
            self._bwd = None
            self._bwd = (x.unit, self._gather(x.unit, live=False))
        return self._bwd[1].as_strided(x.size, x.stride, x.offset)

    @contextlib.contextmanager
    def forward_context(self):
        """Around a forward whose backward follows: at stage 3 its gathers
        are counted (each is a gradient delivery its unit waits for) and
        saved views of gathered units become tokens."""
        if not self._unit_of:
            yield
            return
        self._forwarding = True
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack):
                yield
        finally:
            self._forwarding = False

    # ------------------------------------------------ whole state (checkpoint)
    def _whole_unit(self, source: Source, u: int) -> torch.Tensor:
        """Unit ``u``'s whole flat buffer of ``source``, gathered where it is
        partitioned (a collective)."""
        unit = self.plan.units[u]
        if isinstance(source, str):
            return self._gather(u, live=False) if unit.partitioned else self.whole[u]
        part = source[u]
        if not self.sharded or self.group is None:
            return part
        buf = torch.empty(unit.length, dtype=part.dtype, device=part.device)
        comm.all_gather_into_tensor(buf, part, group=self.group)
        return buf

    def to_host(self, source: Source, keep: bool = True) -> List[Optional[torch.Tensor]]:
        """Whole per-parameter host copies of ``source`` (``PARAMS``, or a
        list laid out as ``fp32``), gathered one unit at a time: beyond the
        state, the device holds one unit's buffer at most. Every rank calls
        it; ``keep=False`` takes part in the gathers and keeps nothing."""
        out: List[Optional[torch.Tensor]] = [None] * len(self.params)
        for u, unit in enumerate(self.plan.units):
            buf = self._whole_unit(source, u)
            if keep:
                for i in unit.params:
                    out[i] = self._view(buf, i).to("cpu", copy=True)
            del buf
        return out

    @torch.no_grad()
    def load(self, source: Source, tensors: Sequence[torch.Tensor]) -> None:
        """Whole per-parameter ``tensors`` (on any device; a checkpoint's
        are on the host) into ``source``, each rank taking its part, one
        unit at a time."""
        for u, unit in enumerate(self.plan.units):
            if isinstance(source, str):
                dst = self.parts[u] if unit.partitioned else self.whole[u]
                part = unit.partitioned
            else:
                dst, part = source[u], self.sharded
            buf = torch.zeros(unit.length, dtype=dst.dtype,
                              device=tensors[unit.params[0]].device)
            for i in unit.params:
                self._view(buf, i).copy_(tensors[i])
            dst.copy_(self._shard(buf, u) if part else buf)
