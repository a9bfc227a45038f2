"""Inference engine: KV-cache generation on one device.

Counterpart of ``deepspeed_tpu/inference/engine.py``. The JAX engine compiles
prefill and a ``lax.scan`` decode loop into one program; PyTorch runs
eagerly, so here the decode loop is a Python loop over
``module.decode_step``. The loop never waits on the host: the cache position
lives on the device, sampling and EOS masking are tensor operations, and the
tokens come back once, at the end.

Model protocol: ``init_cache(B, max_len)``, ``prefill(ids, cache)`` →
(logits, cache), ``decode_step(token, cache)`` → (logits, cache),
``apply(ids)`` → logits, and ``init_params(generator)``.

This slice has no tensor parallelism, weight quantization or
telemetry-observed path; the config rejects those.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.utils.logging import log_dist


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


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller asks for something else; never a silent CPU."""
    accel = get_accelerator()
    if device is None:
        if not accel.is_available():
            raise RuntimeError("no CUDA device: the port serves on CUDA, and on the CPU "
                               "only when asked with device='cpu'")
        return accel.device(torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not accel.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


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
        steps. Returns (B, T_prompt + max_new_tokens) token ids on the
        engine's device (post-EOS positions hold the EOS token)."""
        ids = self._ids(input_ids)
        max_len = ids.shape[1] + max_new_tokens
        if max_len > self._config.max_out_tokens:
            raise ValueError(f"sequence {max_len} exceeds max_out_tokens "
                             f"{self._config.max_out_tokens}")
        generator = torch.Generator(device=self.device).manual_seed(seed)
        prefill, decode = build_generate_parts(self.module, max_new_tokens, do_sample,
                                               temperature, top_k, top_p, eos_token_id)
        with torch.inference_mode():
            logits, cache = prefill(ids)
            return decode(ids, logits, cache, generator)
