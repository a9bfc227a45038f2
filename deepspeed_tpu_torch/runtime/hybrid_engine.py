"""Hybrid engine: one object that trains and generates over the same weights.

Counterpart of ``deepspeed_tpu/runtime/hybrid_engine.py`` (the reference's
``DeepSpeedHybridEngine``), the RLHF actor: the same model alternates
``generate()`` (experience collection) and ``train_batch()`` (the policy
update) every iteration. The reference flips each module between its
training form and an inference container, gathering ZeRO-3 partitions into
inference shards and releasing them after. Here, as in JAX, nothing is
flipped or copied: ``generate`` runs the model's ``prefill`` and
``decode_step`` over the live training params.

The decode loop is the inference engine's (``inference/engine.py``
``generate_with_loops``): on the card one captured CUDA graph of a decode
step per generate key, replayed for every new token. The graph reads the
params at their addresses, and at ZeRO stages 0-2 the optimizer writes the
new params in place into the same buffers (``runtime/zero/state.py``
``store_params``), so a replay after a step reads the updated weights; at
stage 3 and under ``offload_param`` each module's gather (a copy from its
partition or its host buffer, both written in place by the step) is
captured with the step. Under compression training the graph reads the
compressed weights from the static buffers the engine refreshes for the
current step before each ``generate`` (``compression/compress.py``
``CompressedParams``), so one capture serves every step and every
compression stage. On the CPU the same step runs as an eager loop.

Accounting mirrors JAX's: a key's first call, which captures its graph (the
JAX engine's compile), is left out of the latency and the token count.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.engine import generate_with_loops
from deepspeed_tpu_torch.runtime.config import HYBRID_NOOP_KEYS
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.utils.logging import log_dist


class DeepSpeedHybridEngine(DeepSpeedEngine):
    """The training engine, with ``generate`` over the live training params."""

    def __init__(self, *args, **kwargs):
        self._decode_loops: OrderedDict = OrderedDict()
        super().__init__(*args, **kwargs)
        hc = self._config.hybrid_engine
        self._max_out_tokens = hc.max_out_tokens
        for key in HYBRID_NOOP_KEYS:
            if key in self._config._param_dict.get("hybrid_engine", {}):
                log_dist(f"hybrid_engine.{key} accepted (changes nothing on CUDA): "
                         f"{HYBRID_NOOP_KEYS[key]}", ranks=[0])
        self._generate_latency = 0.0
        self._generate_calls = 0
        self._generated_tokens = 0
        self._captures = 0
        self._capture_s = 0.0
        log_dist("DeepSpeedHybridEngine ready (train<->generate over shared params)",
                 ranks=[0])

    # ----------------------------------------------------------------- modes
    def eval(self):
        """The reference's ``.eval()`` / ``.train()``: they change nothing
        here (generation always reads the live training params)."""
        return self

    def train(self, mode: bool = True):
        return self

    def invalidate_compiled(self) -> None:
        """Also drop the captured decode loops: a graph captured before
        compression was armed reads the raw weights."""
        super().invalidate_compiled()
        self._decode_loops.clear()

    # -------------------------------------------------------------- generate
    def generate(self, input_ids, max_new_tokens: int = 32, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None, seed: Optional[int] = None, **kwargs):
        """Autoregressive generation with the current training params (and
        the current step's compression): prefill, then ``max_new_tokens``
        decode steps, graphed on the card. Returns (B, T + max_new_tokens)
        token ids on the engine's device."""
        module = self.module
        if not hasattr(module, "prefill") or not hasattr(module, "decode_step"):
            raise NotImplementedError(
                "hybrid generate() needs the model inference protocol "
                "(prefill/decode_step/init_cache) — see models/gpt2.py")
        if not torch.is_tensor(input_ids):
            input_ids = torch.from_numpy(np.asarray(input_ids))
        ids = input_ids.to(device=self.device, dtype=torch.long)
        B, T = ids.shape
        if T + max_new_tokens > self._max_out_tokens:
            raise ValueError(f"sequence {T + max_new_tokens} exceeds hybrid_engine."
                             f"max_out_tokens={self._max_out_tokens}")
        self._refresh_compression()
        seed = self._host_rng_seed() if seed is None else seed
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out, loop, made = generate_with_loops(
            self._decode_loops, module, ids, max_new_tokens, do_sample, temperature, top_k,
            top_p, eos_token_id, seed, self.device)
        out = out.clone()         # a normal tensor: the sequences train next
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._generate_calls += 1
        if made:
            self._captures += int(loop.graph is not None)
            self._capture_s += loop.capture_s
        else:
            # steady state: a key's first call (its capture) counts neither
            # its latency nor its tokens
            self._generate_latency += time.perf_counter() - t0
            self._generated_tokens += B * max_new_tokens
        return out

    def _host_rng_seed(self) -> int:
        # a fresh seed per call, so repeated sampling differs across steps
        return self._global_step * 100003 + self._generate_calls

    # ------------------------------------------------------------ accounting
    def generate_samples_per_sec(self) -> float:
        if self._generate_latency == 0:
            return 0.0
        return self._generated_tokens / self._generate_latency

    def hybrid_stats(self) -> dict:
        """The JAX engine's counters, and the decode graphs' captures: how
        many and their seconds (``graphed`` False on the CPU, whose loop runs
        eagerly)."""
        return {"generate_calls": self._generate_calls,
                "generate_latency_s": self._generate_latency,
                "generated_tokens": self._generated_tokens,
                "generate_tok_per_sec": self.generate_samples_per_sec(),
                "graphed": self.device.type == "cuda",
                "captures": self._captures, "capture_s": self._capture_s}
