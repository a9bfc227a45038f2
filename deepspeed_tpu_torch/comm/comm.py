"""The communication layer over ``torch.distributed``.

Counterpart of ``deepspeed_tpu/comm/comm.py`` (and so of the reference's
``deepspeed/comm/comm.py``). The JAX package runs its collectives as XLA
programs over named mesh axes; here each collective is the
``torch.distributed`` call of the same name over a process group: NCCL when
the engine's device is a CUDA card, gloo only when the caller asks for the
CPU (``device="cpu"``). There is no fallback: a failed NCCL set-up or a
failed collective raises.

The collectives keep torch's calling convention (in place, or into an
output tensor; ``async_op=True`` returns the work handle) and the JAX
package's names and ``ReduceOp`` set. ``AVG`` is a sum divided by the group
size on the host's side of the call, so it is defined for every backend and
is synchronous. ``ppermute`` (the JAX collective permute) is built on
``batch_isend_irecv``.

Every collective is wrapped by ``timed_op``: with a ``CommsLogger``
installed (``configure``, the ds_config ``comms_logger`` block) it waits for
the collective to finish (a card synchronize) and records its latency and
message size. With a telemetry session live and no logger it records them
without waiting: on a card tensor the latency is the host's time in the
call (the collective queued, not finished), and the device's time lands in
whichever host span next waits for the card, as every other launch's does.
Without either it costs two ``is None`` checks. A message's size is the
full buffer of the collective on this rank, as nccl-tests counts it: the
output of an all-gather, the input of a reduce-scatter, the tensor of an
all-reduce or broadcast.

Telemetry (the JAX ``timed_op``'s series): each timed collective is a
``cat="comm"`` trace span ``comm:<op>`` carrying ``op``, ``seq``, ``group``
and ``bytes``. ``(op, seq, group)`` matches the k-th collective of an op
over a group on one rank with the k-th on every other
(``profiling/aggregate.py``): ``seq`` counts per (op, group) from the
telemetry session's start (:func:`reset_collective_trace_seq`), and
``group`` names the ``torch.distributed`` group the same way on every rank
of it (:func:`group_desc`). The ``comm/op_latency_seconds`` histogram and
the ``comm/op_calls`` and ``comm/op_bytes`` counters go to the registry;
with a logger also the ``comm/skew`` gauge (max over mean latency of the
op's recent window) and, for a call past twice the recent fastest-half
mean, a ``cat="straggler"`` span of the excess (the goodput
``straggler_wait`` bucket). ``record_phase_span`` records a collective
phase its caller timed the same way.

``init_distributed`` reads the contract torchrun sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) unless it
is given ``init_method``, ``rank`` and ``world_size``; before a NCCL group
it makes ``LOCAL_RANK``'s card the current device.
"""

from __future__ import annotations

import collections
import datetime
import functools
import inspect
import os
import socket
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.utils.logging import log_dist


class ReduceOp:
    """The JAX package's reduction names (reference comm/comm.py:33)."""
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"
    AVG = "avg"
    BAND = "band"
    BOR = "bor"
    BXOR = "bxor"
    UNUSED = "unused"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
              ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.AVG: dist.ReduceOp.SUM, ReduceOp.BAND: dist.ReduceOp.BAND,
              ReduceOp.BOR: dist.ReduceOp.BOR, ReduceOp.BXOR: dist.ReduceOp.BXOR}

# installed by configure(); read it here (deepspeed_tpu_torch.comm.comm), as
# the package's star-import would hold a stale copy
comms_logger = None

__all__ = ["ReduceOp", "CommsLogger", "init_distributed", "is_initialized", "get_rank",
           "get_world_size", "get_local_rank", "get_world_group", "get_backend", "new_group",
           "get_global_rank", "destroy_process_group", "configure", "log_summary",
           "all_reduce", "all_gather_into_tensor", "all_gather", "reduce_scatter",
           "reduce_scatter_tensor",
           "all_to_all_single", "all_to_all", "broadcast", "reduce", "gather", "scatter",
           "barrier", "monitored_barrier", "set_default_barrier_timeout",
           "clear_config_barrier_timeout", "all_gather_coalesced", "all_reduce_coalesced",
           "ppermute", "send", "recv", "allgather_host", "broadcast_object_list",
           "reset_collective_trace_seq", "record_phase_span", "group_desc"]


def _torch_op(op) -> "dist.ReduceOp":
    if op not in _TORCH_OPS:
        raise ValueError(f"reduce op {op!r} not in {sorted(_TORCH_OPS)}")
    return _TORCH_OPS[op]


def _average(tensor: torch.Tensor, op, group, async_op: bool) -> None:
    """Finish an AVG: divide the sum by the group size."""
    if op != ReduceOp.AVG:
        return
    if async_op:
        raise ValueError("ReduceOp.AVG divides after the sum: call it with async_op=False")
    if not tensor.is_floating_point():
        raise TypeError(f"ReduceOp.AVG needs a floating tensor, got {tensor.dtype}")
    tensor.div_(get_world_size(group))


# --------------------------------------------------------------------- setup
def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def _seconds(timeout) -> Optional[datetime.timedelta]:
    if timeout is None:
        return None
    seconds = timeout.total_seconds() if isinstance(timeout, datetime.timedelta) \
        else float(timeout)
    if seconds <= 0:
        raise ValueError(f"timeout must be a positive number of seconds, got {timeout!r}")
    return datetime.timedelta(seconds=seconds)


def init_distributed(dist_backend: Optional[str] = None, auto_mpi_discovery: bool = True,
                     distributed_port: int = 29500, verbose: bool = True, timeout=None,
                     init_method: Optional[str] = None,
                     dist_init_required: Optional[bool] = None, config=None,
                     rank: int = -1, world_size: int = -1, device=None):
    """Join (or, alone, form) the default process group; idempotent.
    Returns the world group.

    The backend follows the device: NCCL for CUDA (the default; raises
    without a card), gloo for ``device="cpu"``. ``dist_backend``, when
    given, must name that backend. The rank and world size are the
    arguments, else ``RANK`` and ``WORLD_SIZE``, else 0 and 1; the
    rendezvous is ``init_method``, else ``MASTER_ADDR`` and ``MASTER_PORT``
    (or ``distributed_port``), else, for a world of one, a free local TCP
    port. ``timeout`` (seconds or a timedelta) bounds the rendezvous and
    every collective of the group."""
    if is_initialized():
        return dist.group.WORLD
    from deepspeed_tpu_torch.accelerator import get_accelerator, resolve_device

    dev = resolve_device(device)
    backend = get_accelerator().communication_backend_name() if dev.type == "cuda" else "gloo"
    if dist_backend is not None and dist_backend != backend:
        raise ValueError(f"dist_backend={dist_backend!r} on a {dev.type} device: the port "
                         f"runs {backend} there and falls back to nothing else")
    if rank < 0:
        rank = _env_int("RANK") or 0
    if world_size < 0:
        world_size = _env_int("WORLD_SIZE") or 1
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR")
        if addr:
            init_method = f"tcp://{addr}:{os.environ.get('MASTER_PORT') or distributed_port}"
        elif world_size == 1:
            init_method = f"tcp://127.0.0.1:{_free_port()}"
        else:
            raise ValueError(f"init_distributed: a world of {world_size} processes needs "
                             "init_method or MASTER_ADDR/MASTER_PORT")
    if backend == "nccl":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(rank % torch.cuda.device_count() if local is None else local)
    kwargs = {"timeout": _seconds(timeout)} if timeout is not None else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kwargs)
    if verbose:
        log_dist(f"process group ready: {backend}, {world_size} process(es)", ranks=[0])
    return dist.group.WORLD


def get_rank(group=None) -> int:
    return dist.get_rank(group) if is_initialized() else 0


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if is_initialized() else 1


def get_local_rank() -> int:
    local = _env_int("LOCAL_RANK")
    return get_rank() if local is None else local


def get_world_group():
    return dist.group.WORLD if is_initialized() else None


def get_backend(group=None) -> Optional[str]:
    return dist.get_backend(group) if is_initialized() else None


def new_group(ranks: Optional[Sequence[int]] = None, timeout=None):
    """A process group of the given global ranks (every rank calls it).
    The JAX package names groups by mesh axes; torch by rank lists."""
    kwargs = {"timeout": _seconds(timeout)} if timeout is not None else {}
    return dist.new_group(ranks=None if ranks is None else list(ranks), **kwargs)


def get_global_rank(group=None, group_rank: int = 0) -> int:
    if not is_initialized():
        return group_rank
    return dist.get_global_rank(group or dist.group.WORLD, group_rank)


def destroy_process_group(group=None) -> None:
    if is_initialized():
        dist.destroy_process_group(group)


# ------------------------------------------------------ collective identity
# per (op, group) sequence numbers stamped onto the timed collectives'
# trace spans: every rank issues the same collectives in the same order,
# so the k-th all_reduce over a group on rank 0 matches the k-th on rank 1
_collective_trace_seq: dict = {}


def _next_collective_seq(op: str, group: str) -> int:
    key = (op, group)
    n = _collective_trace_seq.get(key, 0)
    _collective_trace_seq[key] = n + 1
    return n


def reset_collective_trace_seq() -> None:
    """Restart the per-(op, group) seq counters. The telemetry session's
    constructor calls it: a new session is a new trace file and clock, and
    after an elastic restart a surviving rank and a replaced one must both
    count from 0 or their identities never match again."""
    _collective_trace_seq.clear()


def group_desc(group=None) -> str:
    """The name a collective's group goes by in its trace span, the same on
    every rank of the group: ``world`` for the default group (or one of all
    its ranks), else ``ranks:`` and the group's global ranks joined by
    ``+``."""
    if group is None or not is_initialized() or group is dist.group.WORLD:
        return "world"
    ranks = dist.get_process_group_ranks(group)
    if len(ranks) == dist.get_world_size():
        return "world"
    return "ranks:" + "+".join(str(r) for r in ranks)


# ------------------------------------------------------------- comms logging
def _busbw_factor(op_name: str, n: int) -> float:
    """Bus-bandwidth correction (reference utils/comms_logging.py get_bw):
    what each link moved per byte of the message, for a group of ``n``."""
    if n <= 1:
        return 1.0
    if "all_reduce" in op_name:
        return 2.0 * (n - 1) / n
    if "all_gather" in op_name or "reduce_scatter" in op_name or "all_to_all" in op_name:
        return (n - 1) / n
    return 1.0


class CommsLogger:
    """Per-op, per-size counts and latencies of the timed collectives, in
    the reference's 4-slot record: [count, latencies, algorithm GB/s, bus
    GB/s]. ``prof_all`` logs every op, else only those in ``prof_ops``.

    Besides, the last ``STRAGGLER_WINDOW`` latencies of each (op, size): a
    collective waits for its last rank, so a slow participant stretches
    every rank's latency of the same op, and the skew over the window
    (max over mean) shows an intermittent straggler without a barrier
    (:meth:`straggler_report`, :meth:`window_skew`); :meth:`straggler_excess`
    is one call's latency past its window's fastest-half mean."""
    STRAGGLER_WINDOW = 64       # recent latencies kept per (op, size)
    STRAGGLER_SKEW = 3.0        # max / mean that log_all flags
    STRAGGLER_MIN_SAMPLES = 8   # a colder window has no baseline worth trusting

    def __init__(self, verbose=False, debug=False, prof_all=True, prof_ops=None):
        self.verbose = verbose
        self.debug = debug
        self.prof_all = prof_all
        self.prof_ops = list(prof_ops or [])
        self.comms_dict = {}
        self._recent = {}       # (op, size) -> deque of recent latencies
        self._lock = threading.Lock()

    def wants(self, op_name: str) -> bool:
        return self.prof_all or op_name in self.prof_ops

    def append(self, raw_name, record_name, latency, msg_size, n=1):
        with self._lock:
            sizes = self.comms_dict.setdefault(raw_name, {}).setdefault(
                msg_size, [0, [], [], []])
            sizes[0] += 1
            sizes[1].append(latency)
            if latency > 0:
                algbw = msg_size / latency / 1e9
                sizes[2].append(algbw)
                sizes[3].append(algbw * _busbw_factor(raw_name, n))
            recent = self._recent.get((raw_name, msg_size))
            if recent is None:
                recent = self._recent[(raw_name, msg_size)] = collections.deque(
                    maxlen=self.STRAGGLER_WINDOW)
            recent.append(latency)
        if self.verbose:
            log_dist(f"comm op: {record_name} | msg size: {msg_size} | "
                     f"latency(ms): {latency * 1000:.2f}", ranks=[0])

    def reset_straggler_windows(self) -> None:
        """Drop the recent windows (the cumulative records stay): a
        consumer baselining a new fleet starts them empty."""
        with self._lock:
            self._recent.clear()

    def _window(self, raw_name, msg_size) -> list:
        with self._lock:
            return list(self._recent.get((raw_name, msg_size)) or ())

    def straggler_report(self):
        """[(op, size, calls in the window, mean, max, max / mean)] per
        (op, size) over the recent window."""
        with self._lock:
            snap = {k: list(v) for k, v in self._recent.items()}
        rows = []
        for (op, size), lats in sorted(snap.items()):
            if lats:
                mean = sum(lats) / len(lats)
                rows.append((op, size, len(lats), mean, max(lats),
                             max(lats) / mean if mean > 0 else 0.0))
        return rows

    def window_skew(self, raw_name, msg_size) -> float:
        """One (op, size)'s max over mean latency in its window."""
        lats = self._window(raw_name, msg_size)
        if not lats:
            return 0.0
        mean = sum(lats) / len(lats)
        return max(lats) / mean if mean > 0 else 0.0

    def straggler_excess(self, raw_name, msg_size, latency) -> float:
        """Seconds ``latency`` lies past the mean of the fastest half of its
        window, when the window holds ``STRAGGLER_MIN_SAMPLES`` and the call
        took at least twice that mean; else 0.0 (a healthy rank's
        ``straggler_wait`` stays empty)."""
        lats = self._window(raw_name, msg_size)
        if len(lats) < self.STRAGGLER_MIN_SAMPLES:
            return 0.0
        fastest = sorted(lats)[:max(1, len(lats) // 2)]
        baseline = sum(fastest) / len(fastest)
        if baseline <= 0.0 or latency < 2.0 * baseline:
            return 0.0
        return latency - baseline

    def totals(self) -> dict:
        """{op: {"calls", "bytes", "seconds"}} over everything logged."""
        with self._lock:
            return {op: {"calls": sum(r[0] for r in per.values()),
                         "bytes": sum(size * r[0] for size, r in per.items()),
                         "seconds": sum(sum(r[1]) for r in per.values())}
                    for op, per in self.comms_dict.items()}

    def log_all(self, print_log=True, show_straggler=False):
        lines = ["Comms summary:"]
        with self._lock:
            snap = {op: {size: (r[0], list(r[1]), list(r[2]), list(r[3]))
                         for size, r in per.items()} for op, per in self.comms_dict.items()}
        for op, per_size in snap.items():
            for size, (count, lats, bws, busbws) in sorted(per_size.items()):
                mean = lambda xs: sum(xs) / len(xs) if xs else 0.0
                lines.append(f"  {op:26s} size={size:>12d} count={count:>6d} "
                             f"avg_lat={mean(lats) * 1e3:8.3f}ms "
                             f"algo_bw={mean(bws):8.2f}GB/s bus_bw={mean(busbws):8.2f}GB/s")
        if show_straggler:
            lines.append(f"Straggler skew (max vs mean latency, last "
                         f"{self.STRAGGLER_WINDOW} calls per op/size):")
            for op, size, cnt, mean, worst, skew in self.straggler_report():
                flag = "  <-- straggler" if skew >= self.STRAGGLER_SKEW and cnt >= 4 else ""
                lines.append(f"  {op:26s} size={size:>12d} window={cnt:>4d} "
                             f"mean={mean * 1e3:8.3f}ms max={worst * 1e3:8.3f}ms "
                             f"skew={skew:5.2f}x{flag}")
        if print_log:
            log_dist("\n".join(lines), ranks=[0])
        return self.comms_dict


def configure(deepspeed_config=None, enabled=None, prof_all=None, prof_ops=None,
              verbose=None, debug=None):
    """Install a CommsLogger when the ds_config ``comms_logger`` block (or
    ``enabled``) asks for one; ``enabled=False`` removes the current one,
    and a block that asks for none leaves it."""
    global comms_logger
    if enabled is False:
        comms_logger = None
        return
    cc = deepspeed_config.comms_config if deepspeed_config is not None else None
    pick = lambda arg, key, default: arg if arg is not None else \
        (getattr(cc, key) if cc is not None else default)
    if pick(enabled, "enabled", False):
        comms_logger = CommsLogger(verbose=pick(verbose, "verbose", False),
                                   debug=pick(debug, "debug", False),
                                   prof_all=pick(prof_all, "prof_all", True),
                                   prof_ops=pick(prof_ops, "prof_ops", []))


def log_summary():
    if comms_logger is not None:
        return comms_logger.log_all()


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if torch.is_tensor(t) else 0


def _record(op: str, seconds: float, nbytes: int, group, n: int, log_name: str) -> None:
    """One timed collective (or collective phase) into the comms logger and
    the live telemetry session: the series, the straggler excess span and
    the rank-matchable ``cat="comm"`` span."""
    logger = comms_logger
    registry = telemetry.get_registry()
    tracer = telemetry.get_tracer()
    if logger is not None and logger.wants(op):
        logger.append(op, log_name, seconds, nbytes, n=n)
        if registry.enabled:
            registry.gauge("comm/skew", labels={"op": op, "size": str(nbytes)}).set(
                logger.window_skew(op, nbytes))
        excess = logger.straggler_excess(op, nbytes, seconds)
        if excess > 0.0:
            # the slice of the call past the recent baseline: it outranks
            # exposed comm in the goodput taxonomy
            tracer.complete("straggler_wait", excess * 1e6, cat="straggler", op=op)
            if registry.enabled:
                registry.counter("comm/straggler_excess_us").inc(excess * 1e6)
    if registry.enabled:
        registry.histogram("comm/op_latency_seconds",
                           labels={"op": op, "size": str(nbytes)}).observe(seconds)
        registry.counter("comm/op_calls", labels={"op": op}).inc()
        registry.counter("comm/op_bytes", labels={"op": op}).inc(nbytes)
    gd = group_desc(group)
    tracer.complete(f"comm:{op}", seconds * 1e6, cat="comm", op=op,
                    seq=_next_collective_seq(op, gd), group=gd, bytes=nbytes)


def record_phase_span(op: str, seconds: float, group=None, nbytes: int = 0) -> None:
    """Record a collective phase its caller dispatched and timed to
    completion (a sequence of collectives counted as one) as a timed
    collective is recorded: the logger's windows, the series and a
    ``cat="comm"`` span with the same ``(op, seq, group)`` identity."""
    _record(op, float(seconds), int(nbytes), group, get_world_size(group), op)


def timed_op(size_arg: str = "tensor"):
    """Time a collective into the comms logger and the telemetry session
    (:func:`_record`); the message size is the bytes of the argument
    ``size_arg``. Only the logger waits for a card collective to finish."""
    def wrap(func):
        params = inspect.signature(func).parameters
        names = list(params)

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            logger = comms_logger
            waited = logger is not None and logger.wants(func.__name__)
            if not waited and telemetry.get_session() is None:
                return func(*args, **kwargs)
            bound = dict(zip(names, args), **kwargs)
            t0 = time.perf_counter()
            result = func(*args, **kwargs)
            msg = bound.get(size_arg)
            if waited and torch.is_tensor(msg) and msg.is_cuda:
                torch.cuda.synchronize(msg.device)
            latency = time.perf_counter() - t0
            size = sum(_nbytes(t) for t in msg) if isinstance(msg, (list, tuple)) \
                else _nbytes(msg)
            group = bound.get("group")
            _record(func.__name__, latency, size, group, get_world_size(group),
                    bound.get("log_name", func.__name__))
            return result

        return wrapper
    return wrap


# --------------------------------------------------------------- collectives
@timed_op()
def all_reduce(tensor, op=ReduceOp.SUM, group=None, async_op=False, log_name="all_reduce"):
    """Reduce ``tensor`` in place over the group; returns it (or the work
    handle with ``async_op``)."""
    work = dist.all_reduce(tensor, op=_torch_op(op), group=group, async_op=async_op)
    _average(tensor, op, group, async_op)
    return work if async_op else tensor


@timed_op("output_tensor")
def all_gather_into_tensor(output_tensor, tensor, group=None, async_op=False):
    """Every rank's ``tensor`` concatenated along dim 0 into ``output_tensor``."""
    work = dist.all_gather_into_tensor(output_tensor, tensor, group=group, async_op=async_op)
    return work if async_op else output_tensor


@timed_op("tensor_list")
def all_gather(tensor_list, tensor, group=None, async_op=False):
    """Every rank's ``tensor`` into ``tensor_list`` (one tensor per rank)."""
    work = dist.all_gather(tensor_list, tensor, group=group, async_op=async_op)
    return work if async_op else tensor_list


@timed_op()
def reduce_scatter_tensor(output, tensor, op=ReduceOp.SUM, group=None, async_op=False):
    """The reduction of every rank's ``tensor``, split along dim 0; this
    rank's chunk into ``output``."""
    work = dist.reduce_scatter_tensor(output, tensor, op=_torch_op(op), group=group,
                                      async_op=async_op)
    _average(output, op, group, async_op)
    return work if async_op else output


@timed_op()
def reduce_scatter(tensor, group=None, op=ReduceOp.SUM, scatter_dimension: int = 0,
                   tiled: bool = True, log_name="reduce_scatter") -> torch.Tensor:
    """The functional reduce-scatter (JAX ``psum_scatter``): the reduction
    of every rank's whole ``tensor``, split along ``scatter_dimension`` into
    one shard per rank; returns this rank's shard as a new tensor. With
    ``tiled=False`` that dimension must equal the group size and is
    dropped from the shard. The JAX eager form takes the group's inputs
    stacked on a leading dimension, bookkeeping of its single controller
    that a process per rank has no use for."""
    world = get_world_size(group)
    dim = scatter_dimension % tensor.dim()
    if tensor.shape[dim] % world:
        raise ValueError(f"reduce_scatter: dimension {dim} of {tuple(tensor.shape)} does not "
                         f"split into {world} shards")
    if not tiled and tensor.shape[dim] != world:
        raise ValueError(f"reduce_scatter(tiled=False): dimension {dim} of "
                         f"{tuple(tensor.shape)} must equal the group size {world}")
    moved = tensor.movedim(dim, 0).contiguous()
    out = moved.new_empty(moved.shape[0] // world, *moved.shape[1:])
    dist.reduce_scatter_tensor(out, moved, op=_torch_op(op), group=group)
    _average(out, op, group, False)
    out = out.movedim(0, dim)
    return out if tiled else out.squeeze(dim)


@timed_op()
def all_to_all_single(output, tensor, output_split_sizes=None, input_split_sizes=None,
                      group=None, async_op=False):
    """Chunk j of ``tensor`` (dim 0) goes to rank j; chunk i of ``output``
    comes from rank i (the MoE dispatch primitive)."""
    work = dist.all_to_all_single(output, tensor, output_split_sizes, input_split_sizes,
                                  group=group, async_op=async_op)
    return work if async_op else output


all_to_all = all_to_all_single


@timed_op()
def broadcast(tensor, src=0, group=None, async_op=False, log_name="broadcast"):
    """``src``'s ``tensor`` into every rank's, in place (``src`` global)."""
    work = dist.broadcast(tensor, src=src, group=group, async_op=async_op)
    return work if async_op else tensor


@timed_op()
def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, async_op=False):
    """The reduction into ``dst``'s ``tensor``; other ranks' are scratch."""
    work = dist.reduce(tensor, dst=dst, op=_torch_op(op), group=group, async_op=async_op)
    if get_rank() == dst:
        _average(tensor, op, group, async_op)
    return work if async_op else tensor


@timed_op()
def gather(tensor, gather_list=None, dst=0, group=None, async_op=False):
    """Every rank's ``tensor`` into ``dst``'s ``gather_list``."""
    work = dist.gather(tensor, gather_list if get_rank() == dst else None, dst=dst,
                       group=group, async_op=async_op)
    return work if async_op else gather_list


@timed_op()
def scatter(tensor, scatter_list=None, src=0, group=None, async_op=False):
    """Chunk i of ``src``'s ``scatter_list`` into rank i's ``tensor``."""
    work = dist.scatter(tensor, scatter_list if get_rank() == src else None, src=src,
                        group=group, async_op=async_op)
    return work if async_op else tensor


def _barrier_kwargs(group) -> dict:
    if get_backend(group) == "nccl":
        return {"device_ids": [torch.cuda.current_device()]}
    return {}


def barrier(group=None, log_name="barrier") -> None:
    if is_initialized():
        dist.barrier(group=group, **_barrier_kwargs(group))


_default_barrier_timeout: Optional[float] = None
_default_barrier_timeout_source: Optional[str] = None


def set_default_barrier_timeout(timeout: Optional[float], source: str = "manual") -> None:
    """The deadline of ``monitored_barrier`` calls that pass none (None:
    no deadline). ``source`` "config" marks a default an engine installed
    from its config; :func:`clear_config_barrier_timeout` removes only
    such a one, never a manual install."""
    global _default_barrier_timeout, _default_barrier_timeout_source
    if timeout is not None and timeout <= 0:
        raise ValueError(f"barrier timeout must be positive, got {timeout!r}")
    _default_barrier_timeout = timeout
    _default_barrier_timeout_source = None if timeout is None else source


def clear_config_barrier_timeout() -> None:
    """Remove a barrier default installed with ``source="config"``; a
    manual one stays."""
    global _default_barrier_timeout, _default_barrier_timeout_source
    if _default_barrier_timeout_source == "config":
        _default_barrier_timeout = None
        _default_barrier_timeout_source = None


def monitored_barrier(group=None, timeout=None, wait_all_ranks=False,
                      log_name="monitored_barrier") -> None:
    """A barrier that raises after ``timeout`` seconds (else the default of
    :func:`set_default_barrier_timeout`) instead of hanging. gloo names the
    ranks that did not arrive (``wait_all_ranks``); NCCL, which has no
    monitored barrier, waits on its barrier's work handle with the
    deadline."""
    if not is_initialized():
        return
    timeout = _seconds(_default_barrier_timeout if timeout is None else timeout)
    if get_backend(group) == "gloo":
        kwargs = {"timeout": timeout} if timeout is not None else {}
        dist.monitored_barrier(group=group, wait_all_ranks=wait_all_ranks, **kwargs)
        return
    work = dist.barrier(group=group, async_op=True, **_barrier_kwargs(group))
    if timeout is None:
        work.wait()
    else:
        work.wait(timeout)


def _coalesce(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"coalesced collectives need one dtype, got {sorted(map(str, dtypes))}")
    return torch.cat([t.reshape(-1) for t in tensors])


@timed_op("tensors")
def all_gather_coalesced(tensors, group=None) -> List[torch.Tensor]:
    """Each tensor gathered from every rank and concatenated along dim 0
    (as ``all_gather_into_tensor``), in one collective."""
    if not tensors:
        return []
    flat = _coalesce(tensors)
    world = get_world_size(group)
    out = flat.new_empty(world * flat.numel())
    dist.all_gather_into_tensor(out, flat, group=group)
    rows = out.view(world, -1)
    result, off = [], 0
    for t in tensors:
        n = t.numel()
        piece = rows[:, off:off + n].reshape(world, *t.shape)
        result.append(piece.reshape(world * t.shape[0], *t.shape[1:]) if t.dim() else piece)
        off += n
    return result


@timed_op("tensors")
def all_reduce_coalesced(tensors, op=ReduceOp.SUM, group=None) -> List[torch.Tensor]:
    """Reduce every tensor in place with one collective; returns them."""
    if not tensors:
        return []
    flat = _coalesce(tensors)
    dist.all_reduce(flat, op=_torch_op(op), group=group)
    _average(flat, op, group, False)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return list(tensors)


def ppermute(tensor, perm, group=None) -> torch.Tensor:
    """The collective permute: for each (src, dst) of ``perm`` (group
    ranks), ``src``'s ``tensor`` lands in ``dst``'s result; a rank that
    receives nothing gets zeros, as ``jax.lax.ppermute`` gives."""
    me = get_rank(group)
    out = torch.zeros_like(tensor)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(tensor)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, tensor, get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def send(tensor, dst: int, group=None, tag: int = 0) -> None:
    dist.send(tensor, dst=dst, group=group, tag=tag)


def recv(tensor, src: int, group=None, tag: int = 0) -> torch.Tensor:
    dist.recv(tensor, src=src, group=group, tag=tag)
    return tensor


# ------------------------------------------------------------------ host-side
def allgather_host(value, log_name="allgather_host") -> np.ndarray:
    """Every process's numpy ``value`` stacked on a leading process dim."""
    arr = np.asarray(value)
    if not is_initialized() or get_world_size() == 1:
        return arr[None, ...]
    got = [None] * get_world_size()
    dist.all_gather_object(got, arr)
    return np.stack(got)


def broadcast_object_list(obj_list, src=0, group=None):
    """``src``'s picklable objects into every rank's ``obj_list``, in place;
    returns it."""
    if is_initialized() and get_world_size(group) > 1:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if get_backend(group) == "nccl" else None
        dist.broadcast_object_list(obj_list, src=src, group=group, device=device)
    return obj_list

