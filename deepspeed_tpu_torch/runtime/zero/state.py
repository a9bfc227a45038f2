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
at stages 1–3. A *fetched* unit's parameters hold no storage: the rank
keeps its part of the unit in the compute type (its shard at stage 3; the
whole unit, in host memory, under ``offload_param``), and
``gather(module)`` brings the unit whole to the card just before the
module computes (a copy from the host and, where partitioned, an
all-gather; an autograd Function whose backward adds the gradients into
the unit's buffer), ``release(module)`` after. Autograd would keep the
gathered buffer alive until backward wherever an op saves a weight, so
while the engine runs a forward, ``saved_tensor_hooks`` replaces every
saved view of a live gathered buffer with a token, and backward gathers
the unit again when it unpacks one (keeping the last unit gathered in
backward until another is asked for).
A block under activation checkpointing gathers again when it is recomputed.

Checkpoints: ``to_host`` copies whole per-parameter tensors to the host
one unit at a time, gathering each partitioned unit; ``load`` gives each
rank its part of whole tensors, one unit at a time. Both first wait for
the card when state lives in host memory (``host_sync``).

The buffers are built unit by unit from chunks of the parameters' values
in their final placement, the rank's parts only (``runtime/zero/init.py``
draws them).

Without a process group (one process, nothing initialized) the same
buffers are used and no collective is issued; with one, every collective
runs, a world of one included.
"""

from __future__ import annotations

import contextlib
import types
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.ops.aio import host_zeros
from deepspeed_tpu_torch.runtime.zero.partition import ZeroPlan

# a source of whole tensors: the compute-type params, or per-unit tensors
# laid out as ZeroState.fp32 (the masters, an optimizer moment, gradients)
PARAMS = "params"
Source = Union[str, Sequence[torch.Tensor]]
# (param index, first element, fp32 values): a piece of one parameter's
# flattened values, as ZeroState is built from
Chunk = Tuple[int, int, torch.Tensor]


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
    no collectives).

    The buffers are built from ``chunks``, ``(param index, start, fp32
    tensor)`` triples giving elements ``[start, start + numel)`` of a
    parameter's flattened values, on any device and in any order: each
    unit's buffers are allocated in their final placement at the unit's
    first chunk, and each chunk is written into the parts of them this rank
    keeps and then dropped, so beyond the state the build holds one chunk
    (``runtime/zero/init.py``). With ``broadcast`` every chunk is first
    broadcast from rank 0, so every rank starts from rank 0's values. Every
    kept element must arrive.

    Placement: ``fp32_host`` keeps ``fp32`` in host memory (ZeRO-Offload's
    master on the host); ``param_host`` keeps the compute-type params in
    host memory (``offload_param``), every unit then fetched to the card
    before its module runs, as a stage-3 unit is gathered (at stage 3 the
    persistent unit stays on the card). Host tensors are pinned when
    ``pin``. ``fp32_sink(u, tensor)``, when given, takes each unit's fp32
    part as soon as it is complete in place of keeping it (the NVMe
    optimizer's files), and ``fp32`` then holds None."""

    def __init__(self, plan: ZeroPlan, params: Sequence[torch.nn.Parameter],
                 owners: Sequence[torch.nn.Module], chunks: Iterable[Chunk],
                 dtype: torch.dtype, grad_dtype: torch.dtype, device: torch.device,
                 group=None, rank: int = 0, *, broadcast: bool = True, fp32_host: bool = False,
                 param_host: bool = False, pin: bool = False,
                 fp32_sink: Optional[Callable[[int, torch.Tensor], None]] = None):
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
        self._due: Dict[int, int] = {}          # fetched unit -> its gathers this forward
        self._forwarding = False
        self._live: Dict[int, tuple] = {}       # storage ptr -> (unit, buffer)
        self._bwd: Optional[tuple] = None       # (unit, buffer) gathered in backward
        self._unit_of: Dict[int, int] = {}      # id(module) -> fetched unit
        self._names: Dict[int, List[str]] = {}  # id(module) -> its direct param names
        for m in {id(m): m for m in owners}.values():
            self._names[id(m)] = [n for n, p in m.named_parameters(recurse=False)
                                  if p.requires_grad]
        # a unit is fetched (gathered before its module runs) when its
        # compute-type params are partitioned or in host memory
        self.fetched = [u.partitioned or (param_host and u.name != "persistent")
                        for u in plan.units]
        self.host_state = fp32_host or param_host

        self.fp32: List[Optional[torch.Tensor]] = [None] * len(plan.units)
        self.whole: Dict[int, torch.Tensor] = {}   # compute-type buffer of a whole unit
        self.parts: Dict[int, torch.Tensor] = {}   # compute-type part of a fetched unit

        def zeros(n, dt, on_host):
            return host_zeros(n, dt, pin) if on_host else torch.zeros(n, dtype=dt, device=device)

        def kept(u):
            """(start, end) of the unit's elements this rank keeps in fp32
            and in the compute type."""
            unit = plan.units[u]
            shard = (rank * unit.shard, (rank + 1) * unit.shard)
            return (shard if self.sharded else (0, unit.length),
                    shard if unit.partitioned else (0, unit.length))

        def overlap(a, b):
            return max(0, min(a[1], b[1]) - max(a[0], b[0]))

        want = [[sum(overlap((plan.params[i].offset, plan.params[i].offset
                              + plan.params[i].numel), r) for i in unit.params)
                 for r in kept(u)] for u, unit in enumerate(plan.units)]
        got = [[0, 0] for _ in plan.units]
        sunk = set()
        with torch.no_grad():
            for i, start, t in chunks:
                p = plan.params[i]
                u = p.unit
                t = t.detach().reshape(-1).to(device, torch.float32)
                if broadcast and group is not None:
                    t = t.contiguous()
                    comm.broadcast(t, src=0, group=group)
                (f_lo, f_hi), (c_lo, c_hi) = kept(u)
                if u not in self.whole and u not in self.parts:
                    self.fp32[u] = zeros(f_hi - f_lo, torch.float32, fp32_host)
                    buf = zeros(c_hi - c_lo, dtype, param_host and self.fetched[u])
                    (self.parts if self.fetched[u] else self.whole)[u] = buf
                lo = p.offset + start
                hi = lo + t.numel()
                for j, (dst, (k_lo, k_hi)) in enumerate(zip(
                        (self.fp32[u], self.parts.get(u, self.whole.get(u))), kept(u))):
                    a, b = max(lo, k_lo), min(hi, k_hi)
                    if a < b and not (j == 0 and u in sunk):
                        dst[a - k_lo:b - k_lo].copy_(t[a - lo:b - lo])
                        got[u][j] += b - a
                if fp32_sink is not None and u not in sunk and got[u][0] == want[u][0]:
                    fp32_sink(u, self.fp32[u])
                    self.fp32[u] = None
                    sunk.add(u)
                del t
        for u, unit in enumerate(plan.units):
            if got[u] != want[u]:
                raise ValueError(f"ZeRO unit {unit.name!r}: {got[u]} of {want[u]} kept "
                                 "(fp32, compute-type) elements arrived from the chunks")
            for i in unit.params:
                if self.fetched[u]:
                    self.params[i].data = torch.empty(0, dtype=dtype, device=device)
                    self._unit_of[id(owners[i])] = u
                else:
                    self.params[i].data = self._view(self.whole[u], i)

    def local_chunks(self) -> Iterable[Chunk]:
        """The compute-type values this rank holds, as chunks: each
        parameter's part of the unit's kept range (a stage-3 shard, or the
        whole), for another state built from the same plan."""
        for u, unit in enumerate(self.plan.units):
            buf = self.parts[u] if self.fetched[u] else self.whole[u]
            base = self.rank * unit.shard if unit.partitioned else 0
            for i in unit.params:
                p = self.plan.params[i]
                a = max(p.offset, base)
                b = min(p.offset + p.numel, base + buf.numel())
                if a < b:
                    yield i, a - p.offset, buf[a - base:b - base]

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
        if n >= (self._due.get(u, 0) if self.fetched[u] else len(unit.params)):
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
    def param_slot(self, u: int) -> Optional[torch.Tensor]:
        """The tensor holding unit ``u``'s compute-type params laid out as
        ``fp32[u]`` (on the card or the host), when there is one: the update
        may write the new params into it element for element. None when
        they must be gathered over the group (:meth:`store_params`)."""
        if self.fetched[u] and self.plan.units[u].partitioned:
            return self.parts[u]
        if self.sharded and self.group is not None:
            return None
        return self.parts[u] if self.fetched[u] else self.whole[u]

    @torch.no_grad()
    def store_params(self, u: int, values: torch.Tensor) -> None:
        """Unit ``u``'s compute-type params from ``values``, laid out as
        ``fp32[u]`` (fp32 or the compute type, on any device): cast on the
        card, then copied into place or gathered over the group."""
        values = values.to(self.device)
        slot = self.param_slot(u)
        if slot is not None and slot.device == values.device:
            slot.copy_(values)                    # the cast fused into the copy
            return
        values = values.to(self.dtype)
        if slot is not None:
            slot.copy_(values, non_blocking=True)
            return
        whole = self.whole[u] if not self.fetched[u] else torch.empty(
            self.plan.units[u].length, dtype=self.dtype, device=self.device)
        comm.all_gather_into_tensor(whole, values, group=self.group)
        if self.fetched[u]:
            self.parts[u].copy_(whole, non_blocking=True)

    def refresh_params(self, fp32: Optional[Sequence[torch.Tensor]] = None) -> None:
        """The compute-type params from the updated fp32 values (``fp32``,
        laid out as :attr:`fp32`; the state's own by default)."""
        for u, values in enumerate(self.fp32 if fp32 is None else fp32):
            self.store_params(u, values)

    def host_sync(self) -> None:
        """Wait for the card before the host reads or writes host-resident
        state (a checkpoint, a load): the update's copies to the host run
        on their own stream and the host does not wait for them."""
        if self.host_state and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------- stage 3: gather
    def _gather(self, u: int, live: bool) -> torch.Tensor:
        """Fetched unit ``u``'s compute-type params, whole, on the card:
        copied from the host and, where partitioned, all-gathered."""
        unit = self.plan.units[u]
        src = self.parts[u]
        buf = torch.empty(unit.length, dtype=self.dtype, device=self.device)
        if not unit.partitioned or self.group is None:
            buf.copy_(src, non_blocking=True)
        else:
            comm.all_gather_into_tensor(buf, src.to(self.device, non_blocking=True),
                                        group=self.group)
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
            return self._gather(u, live=False) if self.fetched[u] else self.whole[u]
        part = source[u]
        if not self.sharded or self.group is None:
            return part
        part = part.to(self.device)               # a host part (offload) gathers on the card
        buf = torch.empty(unit.length, dtype=part.dtype, device=self.device)
        comm.all_gather_into_tensor(buf, part, group=self.group)
        return buf

    def to_host(self, source: Source, keep: bool = True) -> List[Optional[torch.Tensor]]:
        """Whole per-parameter host copies of ``source`` (``PARAMS``, or a
        list laid out as ``fp32``), gathered one unit at a time: beyond the
        state, the device holds one unit's buffer at most. Every rank calls
        it; ``keep=False`` takes part in the gathers and keeps nothing.
        ``source[u]`` may read the unit from elsewhere (the NVMe files)."""
        self.host_sync()
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
        unit at a time; a source with ``write_unit(u, tensor)`` (the NVMe
        files) takes each unit's part through it."""
        self.host_sync()
        for u, unit in enumerate(self.plan.units):
            if isinstance(source, str):
                dst = self.parts[u] if self.fetched[u] else self.whole[u]
                part = unit.partitioned
            else:
                dst, part = (None if hasattr(source, "write_unit") else source[u]), self.sharded
            dtype = torch.float32 if dst is None else dst.dtype
            buf = torch.zeros(unit.length, dtype=dtype, device=tensors[unit.params[0]].device)
            for i in unit.params:
                self._view(buf, i).copy_(tensors[i])
            value = self._shard(buf, u) if part else buf
            if dst is None:
                source.write_unit(u, value)
            else:
                dst.copy_(value)
