"""Inference engine: KV-cache generation on one device.

Counterpart of ``deepspeed_tpu/inference/engine.py``. The JAX engine compiles
the decode loop into one program (``lax.scan`` over new tokens, sampling
included) and reuses it per key. Here ``generate`` runs prefill eagerly and
the decode loop as replays of one captured ``torch.cuda.CUDAGraph`` of a
decode step (sample → mask finished rows → ``module.decode_step`` → write the
token → advance ``pos``) over static buffers, kept per key like the JAX
engine's compiled programs. On the CPU the same step runs as an eager loop.
Nothing in a step waits on the host: the cache position and the step index
live on the device, sampling and EOS masking are tensor operations, and the
tokens come back once, at the end. :func:`build_generate_parts` is the
ungraphed loop, for comparison. :func:`generate_with_loops` (prefill, then
the key's decode loop) is shared with the hybrid engine
(``runtime/hybrid_engine.py``), which generates over its training params.

An engine keeps the decode loops of its ``DECODE_LOOPS_KEPT`` most recently
used keys; each holds a KV cache of the key's capacity (and on the card a
graph with its memory pool), so an older key's loop is dropped and captured
again when it comes back. The decode kernel merges its chunks through one
set of semaphores per device, so decode launches on a device must not
overlap in time: ``generate`` runs on the device's default stream, and
raises on any other.

Model protocol: ``init_cache(B, max_len)``, ``prefill(ids, cache)`` →
(logits, cache), ``decode_step(token, cache)`` → (logits, cache),
``apply(ids)`` → logits, and ``init_params(generator)``. A model without a
KV cache (BERT, the CLIP text tower, the UNet and the VAE) serves
``forward`` only: ``generate`` raises ``AttributeError``, as the JAX engine
does. ``forward(input_ids, *args)`` hands every positional array to
``module.apply`` (the diffusers surface: a UNet's sample, timestep and
context).

Weights come from ``params`` (a state dict), else from the training tag of
the config's ``checkpoint`` (``load_inference_params``: only the tag's
params, in the serving dtype, on the device), else seed-0 random weights.
A MoE model (``MoEGPT2``) serves in one process, every expert on the
card (``ep_world_size`` 1): its gates route each call's tokens alone, with
the eval capacity factor. This slice has no tensor or expert parallelism;
the config rejects those.

Observed generation: with a telemetry session whose ``inference`` is true,
or after :meth:`InferenceEngine.profile_model_time`, ``generate`` syncs the
device at the end of prefill and of the decode loop (the same path, timed)
and records the ``prefill`` and ``decode`` spans, the ``inference/*``
counters and histograms of the JAX engine, and the per-request model time
(:meth:`InferenceEngine.model_times`).

The serving front-end (``serving/frontend.py``) decodes through a
:class:`ServingLoop` per sampling key: one ``DecodeLoop`` over a B = 1 KV
cache sized once at ``max_out_tokens`` (one captured graph serves every
prompt length), prefilled eagerly, then advanced ``decode_tick_tokens``
steps a tick, the tick's tokens and finished flag read back to the host.

Weight-only quantized serving (``dtype`` int8, as in JAX): the compute runs
in bf16, and with ``quant.enabled`` and ``quant.weight.enabled`` each
eligible weight (``ops/quantizer.py`` ``quantize_params``: 2-D and larger,
not an embedding, norm or bias) is replaced by a ``QuantizedTensor`` of
int8 or int4 codes and its parameter left on ``meta``. The model computes
through ``GatheredModule._gathered`` (``models/common.py``), so the engine
sets its ``param_gatherer`` to a :class:`DequantGatherer`: a module's
quantized weights are dequantized when it reads them, just before use, into
transient tensors that go when the module is done; the whole model is
never dequantized at once. The graphed decode loop captures the dequant
with the rest of the step.
"""

from __future__ import annotations

import contextlib
import gc
import time
from collections import OrderedDict
from typing import Any, List, Mapping, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import telemetry as _telemetry
from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.quantizer import (QuantizedTensor, dequantize_tensor,
                                               quantize_params, quantized_nbytes)
from deepspeed_tpu_torch.utils.logging import log_dist, logger

DECODE_LOOPS_KEPT = 4


def _filter_logits(logits, temperature: float, top_k: int, top_p: float):
    """Temperature, then top-k, then nucleus filtering: the rules of the JAX
    ``_sample``; filtered-out entries are set to -1e30."""
    logits = logits / max(temperature, 1e-6)
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = logits.masked_fill(logits < kth, -1e30)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp_(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, -1e30)
    return logits


def _sample(logits, generator: torch.Generator, temperature: float, top_k: int,
            top_p: float, greedy: bool):
    """Sampling head: greedy / temperature / top-k / nucleus. The draw is
    Gumbel-max with noise from ``generator``, as ``jax.random.categorical``
    draws; the two frameworks' random streams differ."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    logits = _filter_logits(logits, temperature, top_k, top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def _decode_scan_step(module, do_sample: bool, temperature: float, top_k: int,
                      top_p: float, eos: int):
    """One token of the decode loop: sample → mask finished rows → one
    ``module.decode_step``. ``step((logits, cache, done), generator)`` →
    ((logits, cache, done), token)."""

    def step(carry, generator):
        logits, cache, done = carry
        nxt = _sample(logits, generator, temperature, top_k, top_p, greedy=not do_sample)
        nxt = nxt.masked_fill(done, max(eos, 0))
        done = done | (nxt == eos)
        logits, cache = module.decode_step(nxt, cache)
        return (logits, cache, done), nxt

    return step


def build_generate_parts(module, max_new_tokens: int, do_sample: bool,
                         temperature: float, top_k: int, top_p: float,
                         eos_token_id: Optional[int]):
    """Generation split at the prefill/decode boundary: ``prefill(ids)`` →
    (logits, cache) and ``decode(ids, logits, cache, generator)`` → ids with
    ``max_new_tokens`` tokens appended (rows past their EOS hold EOS)."""
    eos = -1 if eos_token_id is None else int(eos_token_id)

    def prefill(ids):
        B, T = ids.shape
        cache = module.init_cache(B, T + max_new_tokens)
        return module.prefill(ids, cache)

    def decode(ids, logits, cache, generator):
        step = _decode_scan_step(module, do_sample, temperature, top_k, top_p, eos)
        carry = (logits, cache, torch.zeros(ids.shape[0], dtype=torch.bool, device=ids.device))
        toks = []
        for _ in range(max_new_tokens):
            carry, nxt = step(carry, generator)
            toks.append(nxt)
        return torch.cat([ids, torch.stack(toks, dim=1).to(ids.dtype)], dim=1)

    return prefill, decode


class DecodeLoop:
    """The decode loop of one generate key over static buffers: the KV cache
    from ``init_cache`` (with its ``pos``), the logits, the finished-row mask,
    the (B, max_new_tokens) token buffer, the step index and the sampling
    generator. :meth:`step` is one token of the loop, updating them in place;
    on a CUDA device it is captured once as a CUDA graph (after one warm-up
    step that loads the kernels) and replayed, on the CPU it runs eagerly.
    The warm-up's launches ran and stay counted; those the graph holds are
    credited to the kernels' counts per replay. ``capture_error_mode`` is
    ``torch.cuda.graph``'s: the serving front-end captures on its tick
    thread with "thread_local", so another thread's CUDA call during the
    capture neither fails it nor is refused."""

    def __init__(self, module, batch: int, prompt_len: int, max_new_tokens: int,
                 do_sample: bool, temperature: float, top_k: int, top_p: float,
                 eos_token_id: Optional[int], device: torch.device,
                 capture_error_mode: str = "global"):
        self.max_new_tokens = max_new_tokens
        self.do_sample = do_sample
        self.device = device
        self.capture_error_mode = capture_error_mode
        self._scan_step = _decode_scan_step(module, do_sample, temperature, top_k, top_p,
                                            -1 if eos_token_id is None else int(eos_token_id))
        self.cache = module.init_cache(batch, prompt_len + max_new_tokens)
        self.logits: Optional[torch.Tensor] = None     # shaped by the first prefill
        self.done = torch.zeros(batch, dtype=torch.bool, device=device)
        self.tokens = torch.zeros(batch, max_new_tokens, dtype=torch.long, device=device)
        self.index = torch.zeros(1, dtype=torch.long, device=device)
        self.generator = torch.Generator(device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.graph_launches: op_builder.LaunchCounts = {}
        self.capture_s = 0.0

    def _store_cache(self, cache) -> None:
        for name, t in cache.items():
            if t is not self.cache[name]:
                self.cache[name].copy_(t)

    def load(self, logits, cache, seed: int) -> None:
        """Start a run: prefill's logits and cache into the static buffers,
        no row finished, step 0, the generator seeded."""
        if self.logits is None:
            self.logits = torch.empty_like(logits)
        self.logits.copy_(logits)
        self._store_cache(cache)
        self.done.zero_()
        self.index.zero_()
        self.generator.manual_seed(seed)

    def step(self) -> None:
        """One token: ``_decode_scan_step`` over the static buffers, its
        results copied back into them, the token written at the step index."""
        (logits, cache, done), tok = self._scan_step((self.logits, self.cache, self.done),
                                                     self.generator)
        self.logits.copy_(logits)
        self._store_cache(cache)
        self.done.copy_(done)
        self.tokens.index_copy_(1, self.index, tok[:, None])
        self.index.add_(1)

    def capture(self) -> None:
        """Warm up one step on a side stream, then capture one step. The
        warm-up's launches ran on the device and stay counted; the captured
        ones, which did not run, are taken back from the kernels' counts and
        kept to credit per replay. The buffers hold the warm-up's state
        afterwards: :meth:`load` before a run."""
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        warm = op_builder.launch_counts()
        graph = torch.cuda.CUDAGraph()
        if self.do_sample:
            graph.register_generator_state(self.generator)
        # a dead graph freed inside the capture (an abandoned loop left in a
        # reference cycle, collected when the capture's allocations trigger
        # the collector) is an operation a capture does not permit and
        # invalidates it: collect before, and not during, the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode=self.capture_error_mode):
                self.step()
        finally:
            if collecting:
                gc.enable()
        captured = op_builder.launch_counts()
        self.graph_launches = {key: n - warm[key] for key, n in captured.items() if n != warm[key]}
        op_builder.add_launches({key: -n for key, n in self.graph_launches.items()})
        self.graph = graph
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        op_builder.stamp_compile("cuda_graph_capture", self.capture_s)

    def start(self, logits, cache, seed: int) -> None:
        """:meth:`load` a run, capturing the step first on a CUDA device
        that has no graph yet (the capture's warm-up step moves the buffers,
        so the run is loaded after it)."""
        if self.device.type == "cuda" and self.graph is None:
            self.load(logits, cache, seed)
            self.capture()
        self.load(logits, cache, seed)

    def advance(self, steps: int) -> None:
        """``steps`` tokens of the loop: graph replays, each credited with
        the graph's launches, on a CUDA device; eager steps on the CPU."""
        if self.device.type != "cuda":
            for _ in range(steps):
                self.step()
            return
        for _ in range(steps):
            self.graph.replay()
            op_builder.add_launches(self.graph_launches)

    def run(self, logits, cache, seed: int) -> torch.Tensor:
        """The decode loop after prefill → the (B, max_new_tokens) new tokens."""
        self.start(logits, cache, seed)
        self.advance(self.max_new_tokens)
        return self.tokens.clone()


class ServingLoop:
    """The serving front-end's decode of one sampling key (the counterpart
    of the JAX ``build_serving_programs``): a :class:`DecodeLoop` at B = 1
    whose KV cache and token buffer are sized once at ``max_total_len``, so
    one captured graph serves every prompt length. :meth:`prefill` runs the
    prompt eagerly into that cache and seeds the loop's generator with the
    request's seed; :meth:`decode_chunk` advances up to ``chunk_tokens``
    steps and brings that tick's tokens and the finished flag to the host.
    A request's tokens are the ones ``generate`` gives for the same prompt,
    sampling parameters and seed: the same step, the same generator draws.
    The capture runs on the first tick after its first prefill, on the tick
    thread, with ``capture_error_mode="thread_local"``."""

    def __init__(self, module, max_total_len: int, chunk_tokens: int, do_sample: bool,
                 temperature: float, top_k: int, top_p: float, eos_token_id: Optional[int],
                 device: torch.device):
        self.module = module
        self.chunk_tokens = int(chunk_tokens)
        self.loop = DecodeLoop(module, 1, 0, int(max_total_len), do_sample, temperature,
                               top_k, top_p, eos_token_id, device,
                               capture_error_mode="thread_local")
        self._start = None       # prefill's (logits, cache, seed) until the first tick
        self.produced = 0

    def prefill(self, ids: torch.Tensor, seed: int) -> None:
        """The (1, T) prompt into the loop's cache; the decode starts at
        the next :meth:`decode_chunk`."""
        logits, cache = self.module.prefill(ids, self.loop.cache)
        self._start = (logits, cache, int(seed))
        self.produced = 0

    def decode_chunk(self, max_steps: Optional[int] = None):
        """Advance ``min(chunk_tokens, max_steps)`` tokens → (that many
        tokens as a list, whether the row has finished), read on the host.
        A request stops at its ``max_new_tokens``, so the loop never writes
        past the cache."""
        if self._start is not None:
            self.loop.start(*self._start)
            self._start = None
        n = self.chunk_tokens if max_steps is None else min(self.chunk_tokens, int(max_steps))
        self.loop.advance(n)
        toks = self.loop.tokens[0, self.produced:self.produced + n].tolist()
        self.produced += n
        return toks, bool(self.loop.done[0].item())

    @property
    def capture_s(self) -> float:
        return self.loop.capture_s


def generate_with_loops(loops: "OrderedDict", module, ids: torch.Tensor, max_new_tokens: int,
                        do_sample: bool, temperature: float, top_k: int, top_p: float,
                        eos_token_id: Optional[int], seed: int, device: torch.device,
                        kept: int = DECODE_LOOPS_KEPT, phase=None):
    """Prefill ``ids`` (B, T) and run the decode loop of the generate key
    from ``loops`` (key → :class:`DecodeLoop`, the ``kept`` most recently
    used, a new loop made and the oldest dropped as needed), on the device's
    default stream. → (ids with the new tokens appended, the loop, whether
    the loop was made by this call). The inference engine and the hybrid
    engine share it. ``phase(name, **args)``, when given, is a context
    manager around the prefill and the decode (:class:`PhaseTimer`)."""
    phase = phase or _no_phase
    B, T = ids.shape
    if device.type == "cuda" and \
            torch.cuda.current_stream(device) != torch.cuda.default_stream(device):
        raise RuntimeError("generate runs on the device's default stream: the decode "
                           "kernel's merge semaphores are shared per device")
    key = (B, T, max_new_tokens, do_sample, temperature, top_k, top_p, eos_token_id)
    with torch.inference_mode():
        loop = loops.pop(key, None)
        made = loop is None
        if made:
            while len(loops) >= kept:
                loops.popitem(last=False)              # its cache and graph go with it
            loop = DecodeLoop(module, B, T, max_new_tokens, do_sample, temperature,
                              top_k, top_p, eos_token_id, device)
        loops[key] = loop
        with phase("prefill", tokens=T):
            logits, cache = module.prefill(ids, loop.cache)
        with phase("decode", tokens=max_new_tokens):
            new = loop.run(logits, cache, seed)
        return torch.cat([ids, new], dim=1), loop, made


def _no_phase(name: str, **args):
    return contextlib.nullcontext()


class PhaseTimer:
    """Times ``generate``'s phases: each ``with timer("prefill"):`` block is a
    tracer span (category ``inference``) that ends with a device sync, and
    its seconds land in ``seconds[name]``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name: str, **args):
        t0 = time.perf_counter()
        with _telemetry.get_tracer().span(name, cat="inference", **args):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.seconds[name] = time.perf_counter() - t0


class _Dequantized:
    """A module's own parameters to compute with: a quantized weight
    dequantized at its first read (then kept until the module is done),
    every other parameter the module's own."""

    def __init__(self, module, quantized: Mapping[str, QuantizedTensor], dtype: torch.dtype):
        self._module, self._quantized, self._dtype = module, quantized, dtype

    def __getattr__(self, name):
        leaf = self._quantized.get(name)
        if leaf is None:
            return getattr(self._module, name)
        value = dequantize_tensor(leaf, self._dtype)
        setattr(self, name, value)
        return value


class DequantGatherer:
    """The ``param_gatherer`` of a weight-quantized model: ``gather(module)``
    gives the module's parameters with its quantized ones dequantized into
    ``dtype`` as they are read, and ``release`` drops those tensors with
    the view. ``quantized``: the model's state dict names of the quantized
    weights → their ``QuantizedTensor``."""

    def __init__(self, model: torch.nn.Module, quantized: Mapping[str, QuantizedTensor],
                 dtype: torch.dtype):
        self.dtype = dtype
        self._owned = {}
        for mname, module in model.named_modules():
            prefix = f"{mname}." if mname else ""
            own = {leaf: quantized[prefix + leaf] for leaf in module._parameters
                   if prefix + leaf in quantized}
            if own:
                self._owned[id(module)] = own

    def gather(self, module):
        own = self._owned.get(id(module))
        return module if own is None else _Dequantized(module, own, self.dtype)

    def release(self, module) -> None:
        return None


class InferenceEngine:
    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None,
                 params: Optional[Mapping[str, Any]] = None, device=None):
        self._config = config or DeepSpeedInferenceConfig()
        self.module = model
        if getattr(model, "ep_size", 1) > 1:
            raise NotImplementedError("serving a model of expert-parallel size "
                                      f"{model.ep_size}: later slice of the port")
        if hasattr(model, "expert_groups"):
            model.expert_groups = None          # one process routes its own tokens
        self.ep_world_size = self._config.ep_size
        self.dtype = self._config.torch_dtype()
        self.device = resolve_device(device)
        if params is None and self._config.checkpoint:
            # a training tag's params, straight into the serving dtype and
            # device: the model's own stay on meta until then
            from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import \
                load_inference_params

            params = load_inference_params(self._config.checkpoint, model, self.dtype,
                                           self.device,
                                           tag=self._config.checkpoint_config.get("tag"))
        if params is not None:
            model.load_state_dict(params, assign=True)
        if any(p.is_meta for p in model.parameters()):
            # no weights given: seed-0 random weights, as the JAX engine does
            model.init_params(torch.Generator(device=self.device).manual_seed(0))
        # every float param, norm gains included, in the serving dtype
        model.to(device=self.device, dtype=self.dtype)
        model.eval()
        self.quantized = {}
        if self._config.quantize_weights:
            self._quantize(model)
        # decode loops by generate key, as the JAX engine keeps its programs;
        # the DECODE_LOOPS_KEPT most recently used
        self._decode_loops: OrderedDict = OrderedDict()
        self._model_profile_enabled = False
        self._model_times: List[float] = []
        log_dist(f"InferenceEngine ready: dtype={self.dtype}, device={self.device}",
                 ranks=[0])

    def _quantize(self, model) -> None:
        """``dtype`` int8: the eligible weights replaced by their quantized
        codes (``quant.weight``), as the JAX engine does; with quantization
        disabled the bf16 weights are served as they are."""
        wq = self._config.quant.weight
        if not (self._config.quant.enabled and wq.enabled):
            log_dist("dtype int8 but quant.weight disabled: serving bf16 weights unquantized",
                     ranks=[0])
            return
        if not hasattr(model, "param_gatherer"):
            raise NotImplementedError(
                f"weight-quantized serving of {type(model).__name__}: the model must compute "
                "through its modules' parameters (param_gatherer, as models/common.py "
                "GatheredModule does)")
        bits = wq.num_bits if wq.num_bits in (4, 8) else 8
        if bits != wq.num_bits:
            logger.warning(f"quant.weight.num_bits={wq.num_bits} unsupported; using {bits}")
        params = dict(model.named_parameters())
        before = sum(p.numel() * p.element_size() for p in params.values())
        with torch.no_grad():
            tree = quantize_params(params, num_bits=bits, symmetric=wq.q_type != "asymmetric",
                                   q_groups=wq.q_groups if wq.q_groups > 1 else None,
                                   min_numel=int(wq.quantized_initialization.get(
                                       "min_numel", 1 << 16)))
        self.quantized = {n: q for n, q in tree.items() if isinstance(q, QuantizedTensor)}
        for name in self.quantized:
            mname, _, leaf = name.rpartition(".")
            owner = model.get_submodule(mname) if mname else model
            old = owner._parameters[leaf]
            owner._parameters[leaf] = torch.nn.Parameter(
                torch.empty(old.shape, dtype=old.dtype, device="meta"), requires_grad=False)
        model.param_gatherer = DequantGatherer(model, self.quantized, self.dtype)
        log_dist(f"weight quantization: {before / 1e6:.1f}MB -> "
                 f"{quantized_nbytes(tree) / 1e6:.1f}MB (int{bits})", ranks=[0])

    def weight_nbytes(self) -> int:
        """The bytes of the weights the engine holds: the model's
        parameters (those not on ``meta``) and the quantized codes and
        scales."""
        held = sum(p.numel() * p.element_size() for p in self.module.parameters()
                   if not p.is_meta)
        return held + sum(q.nbytes for q in self.quantized.values())

    def _ids(self, input_ids) -> torch.Tensor:
        if not torch.is_tensor(input_ids):
            input_ids = torch.from_numpy(np.asarray(input_ids))
        return input_ids.to(device=self.device, dtype=torch.long)

    def _input(self, a) -> torch.Tensor:
        """One positional input of ``forward`` on the engine's device: an
        integer array as ``long``, any other (a float latent, a context)
        with its values and type kept, for the model to cast to its compute
        type as the JAX ``apply`` does."""
        if not torch.is_tensor(a):
            a = torch.from_numpy(np.asarray(a))
        if a.dtype.is_floating_point or a.dtype == torch.bool:
            return a.to(device=self.device)
        return a.to(device=self.device, dtype=torch.long)

    def forward(self, input_ids, *args):
        """``module.apply(input_ids, *args)`` under ``inference_mode``, every
        positional array on the engine's device: an LM's full-sequence
        logits (B, T, V) fp32 from its ids, or the diffusers surface, e.g. a
        UNet's (sample, timestep, encoder_hidden_states) or a VAE's image,
        as the JAX ``forward`` passes extra positional arrays through."""
        xs = [self._input(a) for a in (input_ids, *args)]
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = self.module.apply(*xs)
        if self._model_profile_enabled:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._model_times.append(time.perf_counter() - t0)
        return out

    __call__ = forward

    def generate(self, input_ids, max_new_tokens: int = 32, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None, seed: int = 0, **kwargs):
        """Autoregressive generation: prefill, then ``max_new_tokens`` decode
        steps, replays of a captured CUDA graph on the card (captured, after
        one warm-up step, at the first call with this key) and an eager loop
        of the same step on the CPU. Returns (B, T_prompt + max_new_tokens)
        token ids on the engine's device (post-EOS positions hold the EOS
        token)."""
        ids = self._ids(input_ids)
        T = ids.shape[1]
        if T + max_new_tokens > self._config.max_out_tokens:
            raise ValueError(f"sequence {T + max_new_tokens} exceeds max_out_tokens "
                             f"{self._config.max_out_tokens}")
        session = _telemetry.get_session()
        observed = self._model_profile_enabled or (session is not None
                                                   and session.cfg.inference)
        timer = PhaseTimer(self.device) if observed else None
        out = generate_with_loops(self._decode_loops, self.module, ids, max_new_tokens,
                                  do_sample, temperature, top_k, top_p, eos_token_id, seed,
                                  self.device, phase=timer)[0]
        if observed:
            self._record_generate(timer.seconds, ids.shape[0], max_new_tokens)
        return out

    def _record_generate(self, seconds, batch: int, max_new_tokens: int) -> None:
        """The observed ``generate``'s series, as the JAX engine's
        ``_generate_observed`` records them, and its model time."""
        ttft, decode_s = seconds["prefill"], seconds["decode"]
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("inference/requests").inc(batch)
            reg.counter("inference/generated_tokens").inc(batch * int(max_new_tokens))
            reg.histogram("inference/ttft_seconds").observe(ttft)
            reg.histogram("inference/decode_per_token_seconds").observe(
                decode_s / max(1, int(max_new_tokens)))
            reg.histogram("inference/request_seconds").observe(ttft + decode_s)
        if self._model_profile_enabled:
            self._model_times.append(ttft + decode_s)

    def profile_model_time(self, use_cuda_events: bool = False) -> None:
        """Record each request's model time for :meth:`model_times` (the
        reference's ``_model_times``); ``generate`` becomes observed. The
        times are host seconds to a device sync (``use_cuda_events`` is
        accepted as in the reference)."""
        self._model_profile_enabled = True
        self._model_times = []

    def model_times(self) -> List[float]:
        """Drain and return the per-request model times (seconds)."""
        assert self._model_profile_enabled, \
            "model_times() requires profile_model_time() first (reference contract)"
        times = self._model_times
        self._model_times = []
        return times

    def serving_loop(self, chunk_tokens: int, do_sample: bool = False, temperature: float = 1.0,
                     top_k: int = 0, top_p: float = 1.0,
                     eos_token_id: Optional[int] = None) -> ServingLoop:
        """A :class:`ServingLoop` of one sampling key over this engine's
        model, its cache sized at ``max_out_tokens``."""
        return ServingLoop(self.module, self._config.max_out_tokens, chunk_tokens, do_sample,
                           temperature, top_k, top_p, eos_token_id, self.device)
