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
ungraphed loop, for comparison.

An engine keeps the decode loops of its ``DECODE_LOOPS_KEPT`` most recently
used keys; each holds a KV cache of the key's capacity (and on the card a
graph with its memory pool), so an older key's loop is dropped and captured
again when it comes back. The decode kernel merges its chunks through one
set of semaphores per device, so decode launches on a device must not
overlap in time: ``generate`` runs on the device's default stream, and
raises on any other.

Model protocol: ``init_cache(B, max_len)``, ``prefill(ids, cache)`` →
(logits, cache), ``decode_step(token, cache)`` → (logits, cache),
``apply(ids)`` → logits, and ``init_params(generator)``.

This slice has no tensor parallelism, weight quantization or
telemetry-observed path; the config rejects those.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Mapping, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.utils.logging import log_dist

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
    credited to the kernels' counts per replay."""

    def __init__(self, module, batch: int, prompt_len: int, max_new_tokens: int,
                 do_sample: bool, temperature: float, top_k: int, top_p: float,
                 eos_token_id: Optional[int], device: torch.device):
        self.max_new_tokens = max_new_tokens
        self.do_sample = do_sample
        self.device = device
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
        with torch.cuda.graph(graph):
            self.step()
        captured = op_builder.launch_counts()
        self.graph_launches = {key: n - warm[key] for key, n in captured.items() if n != warm[key]}
        op_builder.add_launches({key: -n for key, n in self.graph_launches.items()})
        self.graph = graph
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0

    def run(self, logits, cache, seed: int) -> torch.Tensor:
        """The decode loop after prefill → the (B, max_new_tokens) new tokens."""
        self.load(logits, cache, seed)
        if self.device.type != "cuda":
            for _ in range(self.max_new_tokens):
                self.step()
            return self.tokens.clone()
        if self.graph is None:
            self.capture()
            self.load(logits, cache, seed)
        for _ in range(self.max_new_tokens):
            self.graph.replay()
            op_builder.add_launches(self.graph_launches)
        return self.tokens.clone()


class InferenceEngine:
    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None,
                 params: Optional[Mapping[str, Any]] = None, device=None):
        self._config = config or DeepSpeedInferenceConfig()
        self.module = model
        self.dtype = self._config.torch_dtype()
        self.device = resolve_device(device)
        if params is not None:
            model.load_state_dict(params, assign=True)
        if any(p.is_meta for p in model.parameters()):
            # no weights given: seed-0 random weights, as the JAX engine does
            model.init_params(torch.Generator(device=self.device).manual_seed(0))
        # every float param, norm gains included, in the serving dtype
        model.to(device=self.device, dtype=self.dtype)
        model.eval()
        # decode loops by generate key, as the JAX engine keeps its programs;
        # the DECODE_LOOPS_KEPT most recently used
        self._decode_loops: OrderedDict = OrderedDict()
        log_dist(f"InferenceEngine ready: dtype={self.dtype}, device={self.device}",
                 ranks=[0])

    def _ids(self, input_ids) -> torch.Tensor:
        if not torch.is_tensor(input_ids):
            input_ids = torch.from_numpy(np.asarray(input_ids))
        return input_ids.to(device=self.device, dtype=torch.long)

    def forward(self, input_ids):
        """Full-sequence logits (B, T, V) fp32."""
        with torch.inference_mode():
            return self.module.apply(self._ids(input_ids))

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
        B, T = ids.shape
        if self.device.type == "cuda" and \
                torch.cuda.current_stream(self.device) != torch.cuda.default_stream(self.device):
            raise RuntimeError("generate runs on the device's default stream: the decode "
                               "kernel's merge semaphores are shared per device")
        if T + max_new_tokens > self._config.max_out_tokens:
            raise ValueError(f"sequence {T + max_new_tokens} exceeds max_out_tokens "
                             f"{self._config.max_out_tokens}")
        key = (B, T, max_new_tokens, do_sample, temperature, top_k, top_p, eos_token_id)
        with torch.inference_mode():
            loop = self._decode_loops.pop(key, None)
            if loop is None:
                while len(self._decode_loops) >= DECODE_LOOPS_KEPT:
                    self._decode_loops.popitem(last=False)   # its cache and graph go with it
                loop = DecodeLoop(self.module, B, T, max_new_tokens, do_sample, temperature,
                                  top_k, top_p, eos_token_id, self.device)
            self._decode_loops[key] = loop
            logits, cache = self.module.prefill(ids, loop.cache)
            return torch.cat([ids, loop.run(logits, cache, seed)], dim=1)
