"""The memory profiler: what holds the card's memory, by name.

Counterpart of ``deepspeed_tpu/profiling/memory.py``, with the same series,
cadence and leak sentinel. Three mechanisms:

* **the census** (:func:`census`): the card's allocated bytes attributed to
  the engine's known state by storage identity (params, fp32 masters,
  optimizer state, the state's other tensors, the flat gradient buffers;
  :func:`named_engine_tensors`). A storage shared by views counts once, for
  the first bucket that claims it. On the card the total is
  ``torch.cuda.memory_allocated()`` and ``other`` the difference: the
  step's activations, caches, the caller's tensors, and the leaks. The
  gauges are ``profiling/live_bytes{bucket=}``, ``profiling/live_bytes_total``
  and ``profiling/attributed_fraction``, as in JAX.
* **per-span peak deltas** (:class:`SpanMemoryTracer`): a wrapper of the
  telemetry ``StepTracer`` that reads the allocator's bytes in use before
  each span and its peak after it, into
  ``profiling/span_peak_bytes{span=}``.
* **the leak sentinel**: total bytes growing at every one of
  ``leak_window`` consecutive samples, by at least
  ``leak_min_growth_bytes``, count ``profiling/leak_suspects{bucket=}`` and
  warn once, naming the bucket that grew most.

XLA's ``memory_analysis`` of the compiled train step has no CUDA
counterpart: the port runs the step eagerly and compiles no program whose
buffers could be read before it runs (:func:`executable_memory`).

The engine arms this module with the ``profiling`` ds_config block; without
it the module is never imported and no census runs.
"""

from __future__ import annotations

import contextlib
import gc
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional

import torch

from deepspeed_tpu_torch.utils.logging import logger

# census calls in this process: tests assert it stays 0 without the block
CENSUS_CALLS = 0


class CensusResult(NamedTuple):
    """One attribution of the allocated bytes to buckets."""
    bucket_bytes: Dict[str, int]
    bucket_counts: Dict[str, int]
    total_bytes: int
    attributed_bytes: int

    @property
    def fraction_attributed(self) -> float:
        return self.attributed_bytes / self.total_bytes if self.total_bytes else 1.0

    @property
    def other_bytes(self) -> int:
        return self.total_bytes - self.attributed_bytes


def _tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nested structure of tensors, lists, tuples (named
    ones too) and dicts; anything else is skipped."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _storage(t: torch.Tensor):
    """(key, bytes) of ``t``'s storage; views of one storage share the key."""
    s = t.untyped_storage()
    return (t.device, s.data_ptr()), s.nbytes()


def named_engine_tensors(engine) -> Dict[str, Any]:
    """The engine's known state, bucket name -> tensors: ``params`` (the
    compute-type ZeRO buffers), ``master`` (the fp32 copy the optimizer
    updates; in fp32 training the port keeps it beside the params, where
    the JAX package's params are the masters), ``optimizer_state``,
    ``state_misc`` (the loss scaler's tensors, if any: the port's step
    counters are host integers) and ``grad_buffer`` (the flat gradient
    buffers, held only inside a step: the boundary releases them)."""
    z = engine._zero
    named: Dict[str, Any] = {"params": [*z.whole.values(), *z.parts.values()]}
    masters = [t for t in z.fp32 if isinstance(t, torch.Tensor)] \
        if isinstance(z.fp32, list) else []
    if masters:
        named["master"] = masters
    if engine.opt_state is not None:
        named["optimizer_state"] = engine.opt_state
    named["state_misc"] = [engine.scaler_state]
    grads = [*z._grads.values(), *z._shard_grads.values()]
    if grads:
        named["grad_buffer"] = grads
    return named


def _live_cpu_tensors() -> List[torch.Tensor]:
    """Every CPU tensor the interpreter holds: the CPU has no allocator
    count, so the census walks the objects instead."""
    # issubclass on the type: isinstance would read __class__ off every
    # object, and some of torch's deprecated aliases warn when read
    return [o for o in gc.get_objects() if issubclass(type(o), torch.Tensor)
            and o.device.type == "cpu"]


def census(named_tensors: Dict[str, Any], live: Optional[List[torch.Tensor]] = None,
           device: Optional[torch.device] = None) -> CensusResult:
    """Attribute the allocated bytes of ``device`` (default: the first
    named tensor's) to the named buckets by storage.

    ``live`` None: on a CUDA device the total is
    ``torch.cuda.memory_allocated(device)`` and each bucket holds its
    storages on the device; on the CPU the live tensors are every CPU
    tensor the interpreter holds. With ``live`` (a list of tensors) only
    those are counted. A storage claimed by two buckets counts for the
    first (the insertion order of ``named_tensors``); live storages no
    bucket claims are ``other``."""
    global CENSUS_CALLS
    CENSUS_CALLS += 1
    if device is None:
        first = next((t for tree in named_tensors.values() for t in _tensors(tree)), None)
        device = first.device if first is not None else torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    owner: Dict[Any, str] = {}
    sizes: Dict[Any, int] = {}
    for bucket, tree in named_tensors.items():
        for t in _tensors(tree):
            if t.device == device:
                key, n = _storage(t)
                owner.setdefault(key, bucket)
                sizes[key] = n
    bucket_bytes = {b: 0 for b in named_tensors}
    bucket_counts = {b: 0 for b in named_tensors}
    if live is None and device.type == "cuda":
        for key, bucket in owner.items():
            bucket_bytes[bucket] += sizes[key]
            bucket_counts[bucket] += 1
        attributed = sum(bucket_bytes.values())
        total = torch.cuda.memory_allocated(device)
        bucket_bytes["other"] = total - attributed
        bucket_counts["other"] = 0          # the allocator counts bytes, not buffers
        return CensusResult(bucket_bytes=bucket_bytes, bucket_counts=bucket_counts,
                            total_bytes=total, attributed_bytes=attributed)
    if live is None:
        live = _live_cpu_tensors()
    seen = set()
    total = attributed = 0
    for t in live:
        if t.device != device:
            continue
        key, n = _storage(t)
        if key in seen:
            continue
        seen.add(key)
        total += n
        bucket = owner.get(key)
        if bucket is None:
            bucket_bytes["other"] = bucket_bytes.get("other", 0) + n
            bucket_counts["other"] = bucket_counts.get("other", 0) + 1
        else:
            attributed += n
            bucket_bytes[bucket] += n
            bucket_counts[bucket] += 1
    return CensusResult(bucket_bytes=bucket_bytes, bucket_counts=bucket_counts,
                        total_bytes=total, attributed_bytes=attributed)


def executable_memory(engine) -> Optional[Dict[str, int]]:
    """None: XLA's ``memory_analysis`` reads the argument, output, temp and
    code bytes of the compiled train-step program before it runs, and the
    port compiles no such program (PyTorch runs the step eagerly, and CUDA
    keeps no buffer plan to read). The step's measured peak is in the
    ``profiling/span_peak_bytes{span=train_batch}`` histogram instead."""
    return None


def device_memory_stats(device: torch.device) -> Callable[[], Optional[dict]]:
    """The allocator's bytes in use and lifetime peak on ``device`` (a CUDA
    device), as a ``stats_fn`` of :class:`SpanMemoryTracer`; on the CPU a
    function that returns None (no allocator statistics there)."""
    if device.type != "cuda":
        return lambda: None
    return lambda: {"bytes_in_use": torch.cuda.memory_allocated(device),
                    "peak_bytes_in_use": torch.cuda.max_memory_allocated(device)}


def _default_memory_stats() -> Optional[dict]:
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return device_memory_stats(torch.device("cuda", torch.cuda.current_device()))()


class SpanMemoryTracer:
    """A ``StepTracer`` wrapper recording each span's peak device memory
    above its entry.

    ``span()`` reads ``bytes_in_use`` before the block and
    ``peak_bytes_in_use`` (at least ``bytes_in_use``) after it; the delta,
    clamped at 0, feeds ``profiling/span_peak_bytes{span=}``. The peak is
    the allocator's lifetime peak: resetting it here
    (``torch.cuda.reset_peak_memory_stats``, process-wide) would break an
    enclosing span's reading and the caller's own, so once the lifetime
    peak is reached later spans saturate, and the first steps, where an
    out-of-memory happens, are attributed exactly. Everything else goes to
    the wrapped tracer; a backend without statistics (the CPU) is probed
    once and then costs nothing."""

    def __init__(self, inner, stats_fn: Optional[Callable[[], Optional[dict]]] = None):
        self.inner = inner
        self._stats = stats_fn or _default_memory_stats
        self._available = True

    def _read(self) -> Optional[dict]:
        if not self._available:
            return None
        stats = self._stats()
        if stats is None:
            self._available = False
        return stats

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "train", **args):
        before = self._read()
        with self.inner.span(name, cat=cat, **args) as s:
            try:
                yield s
            finally:
                after = self._read() if before is not None else None
                if after is not None:
                    from deepspeed_tpu_torch import telemetry

                    in0 = int(before.get("bytes_in_use", 0))
                    peak = max(int(after.get("peak_bytes_in_use", 0)),
                               int(after.get("bytes_in_use", 0)))
                    telemetry.get_registry().histogram(
                        "profiling/span_peak_bytes",
                        labels={"span": name}).observe(max(0, peak - in0))

    def __getattr__(self, name):
        return getattr(self.inner, name)


class MemoryProfiler:
    """Sampling for one engine (the ``profiling`` block).

    ``maybe_sample(engine, step)`` samples at step 1 (the first step sets
    the peak) and every ``sample_interval`` steps: the census into registry
    gauges and the leak sentinel over the census history.
    ``executable_analysis`` records nothing on CUDA (:func:`executable_memory`)
    and says so at the first sample."""

    def __init__(self, sample_interval: int = 10, memory: bool = True,
                 executable_analysis: bool = True, leak_window: int = 5,
                 leak_min_growth_bytes: int = 1 << 20):
        self.sample_interval = max(1, int(sample_interval))
        self.memory = memory
        self.executable_analysis = executable_analysis
        self.leak_window = max(2, int(leak_window))
        self.leak_min_growth_bytes = int(leak_min_growth_bytes)
        self._history = deque(maxlen=self.leak_window + 1)  # (step, total, buckets)
        self._exec_done = False
        self._leak_warned = False
        self.samples = 0

    def maybe_sample(self, engine, step: int) -> None:
        if step != 1 and step % self.sample_interval:
            return
        self.sample(engine, step)

    def sample(self, engine, step: int) -> None:
        from deepspeed_tpu_torch import telemetry

        reg = telemetry.get_registry()
        self.samples += 1
        if self.memory:
            res = census(named_engine_tensors(engine), device=engine.device)
            for bucket, n in res.bucket_bytes.items():
                reg.gauge("profiling/live_bytes", labels={"bucket": bucket}).set(n)
            reg.gauge("profiling/live_bytes_total").set(res.total_bytes)
            reg.gauge("profiling/attributed_fraction").set(res.fraction_attributed)
            self._observe_leak(step, res)
        if self.executable_analysis and not self._exec_done:
            self._exec_done = True
            if executable_memory(engine) is None:
                logger.info("ds_prof: profiling.executable_analysis reads XLA's memory_analysis "
                            "of a compiled step, which CUDA does not have; no "
                            "profiling/executable_* gauges (the step's peak is "
                            "profiling/span_peak_bytes{span=train_batch})")

    # ------------------------------------------------------------- leak sentinel
    def _observe_leak(self, step: int, res: CensusResult) -> None:
        self._history.append((step, res.total_bytes, dict(res.bucket_bytes)))
        if len(self._history) <= self.leak_window:
            return
        totals = [t for _, t, _ in self._history]
        if any(b <= a for a, b in zip(totals, totals[1:])):
            return
        growth = totals[-1] - totals[0]
        if growth < self.leak_min_growth_bytes:
            return
        first, last = self._history[0][2], self._history[-1][2]
        by_growth = {b: last.get(b, 0) - first.get(b, 0)
                     for b in set(first) | set(last)}
        top = max(by_growth, key=by_growth.get)
        from deepspeed_tpu_torch import telemetry

        telemetry.get_registry().counter(
            "profiling/leak_suspects", labels={"bucket": top}).inc()
        if not self._leak_warned:
            self._leak_warned = True
            span = self._history[-1][0] - self._history[0][0]
            logger.warning(
                f"ds_prof leak sentinel: live device bytes grew monotonically "
                f"for {self.leak_window} consecutive samples ({growth} bytes "
                f"over {span} steps); top-growing bucket: {top!r} "
                f"(+{by_growth[top]} bytes)")
