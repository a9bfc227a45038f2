"""LLaMA family decoder, serving path.

Counterpart of ``deepspeed_tpu/models/llama.py``: RMSNorm and RoPE in fp32,
SwiGLU MLP without biases, grouped-query attention whose KV cache holds only
the KV heads, tied or separate LM head. The JAX model is functional over a
stacked param pytree; here :class:`LlamaModel` is an ``nn.Module`` with one
:class:`LlamaBlock` per layer. Weights keep the JAX orientation (``x @ W``,
``q_w`` is (d, d)), so :func:`params_from_jax` copies them exactly.

This slice serves: ``init_cache``, ``prefill``, ``decode_step`` and the full
forward ``apply``. Training (``loss``, remat) and sequence parallelism come
with later slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.common import (_rope_cos_sin, apply_rope,
                                               cached_decode_attention,
                                               local_causal_attention)


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    n_positions: int = 2048          # max sequence length (RoPE has no table)
    n_embd: int = 4096
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: Optional[int] = None  # None → n_head (no GQA)
    intermediate_size: Optional[int] = None  # None → LLaMA's 8/3·d rounded to 256
    rope_theta: float = 10000.0
    # None | {"rope_type": "linear", "factor": f}
    #      | {"rope_type": "llama3", "factor", "low_freq_factor",
    #         "high_freq_factor", "original_max_position_embeddings"}
    rope_scaling: Optional[dict] = None
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False     # llama3.2-1B/3B style tied lm_head
    dtype: Any = torch.bfloat16      # compute and KV-cache type
    use_flash_attention: bool = True
    # the decode-attention kernel; off selects the grouped einsum, as in JAX
    use_flash_decode: bool = False

    VALID_ROPE_TYPES = ("default", "linear", "llama3")

    def __post_init__(self):
        if self.rope_scaling is not None:
            kind = self.rope_scaling.get("rope_type",
                                         self.rope_scaling.get("type", "default"))
            if kind not in self.VALID_ROPE_TYPES:
                raise ValueError(f"rope_scaling type {kind!r} not supported "
                                 f"(have: {self.VALID_ROPE_TYPES})")
        if self.n_kv_head is None:
            self.n_kv_head = self.n_head
        if self.n_head % self.n_kv_head:
            raise ValueError(f"n_head={self.n_head} not divisible by "
                             f"n_kv_head={self.n_kv_head}")
        if self.intermediate_size is None:
            self.intermediate_size = 256 * ((int(8 * self.n_embd / 3) + 255) // 256)

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_head * self.head_dim


_LLAMA3_ROPE = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}

PRESETS = {
    "llama-tiny": LlamaConfig(vocab_size=512, n_positions=128, n_embd=64,
                              n_layer=2, n_head=4, n_kv_head=2,
                              intermediate_size=128),
    "llama-7b": LlamaConfig(),
    # meta-llama/Llama-3.2-1B, with its llama3 rope scaling and 128k context
    "llama3.2-1b": LlamaConfig(vocab_size=128256, n_positions=131072,
                               n_embd=2048, n_layer=16, n_head=32,
                               n_kv_head=8, intermediate_size=8192,
                               rope_theta=500000.0, tie_embeddings=True,
                               rope_scaling={**_LLAMA3_ROPE, "factor": 32.0}),
    "llama-13b": LlamaConfig(n_embd=5120, n_layer=40, n_head=40,
                             intermediate_size=13824),
    "llama2-7b": LlamaConfig(n_positions=4096),
    "llama2-70b": LlamaConfig(n_embd=8192, n_layer=80, n_head=64, n_kv_head=8,
                              n_positions=4096, intermediate_size=28672),
    "llama3-8b": LlamaConfig(vocab_size=128256, n_positions=8192, n_embd=4096,
                             n_layer=32, n_head=32, n_kv_head=8,
                             intermediate_size=14336, rope_theta=500000.0),
    "llama3.1-8b": LlamaConfig(vocab_size=128256, n_positions=131072,
                               n_embd=4096, n_layer=32, n_head=32, n_kv_head=8,
                               intermediate_size=14336, rope_theta=500000.0,
                               rope_scaling=dict(_LLAMA3_ROPE)),
}

# per-layer weights, in the JAX package's ``blocks`` naming
BLOCK_KEYS = ("attn_norm_g", "q_w", "k_w", "v_w", "o_w",
              "mlp_norm_g", "gate_w", "up_w", "down_w")


def _weight(*shape) -> nn.Parameter:
    # allocated on the meta device: a model holds no memory until
    # init_params, params_from_jax or load_state_dict(assign=True) fills it
    return nn.Parameter(torch.empty(*shape, device="meta"), requires_grad=False)


class LlamaBlock(nn.Module):
    """One decoder layer's weights (the computation lives on LlamaModel)."""

    def __init__(self, c: LlamaConfig):
        super().__init__()
        d, i = c.n_embd, c.intermediate_size
        self.attn_norm_g = _weight(d)
        self.q_w = _weight(d, d)
        self.k_w = _weight(d, c.kv_dim)
        self.v_w = _weight(d, c.kv_dim)
        self.o_w = _weight(d, d)
        self.mlp_norm_g = _weight(d)
        self.gate_w = _weight(d, i)
        self.up_w = _weight(d, i)
        self.down_w = _weight(i, d)


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        c = self.config = config
        self.wte = _weight(c.vocab_size, c.n_embd)
        self.blocks = nn.ModuleList(LlamaBlock(c) for _ in range(c.n_layer))
        self.norm_g = _weight(c.n_embd)
        if not c.tie_embeddings:
            self.lm_head = _weight(c.n_embd, c.vocab_size)

    # ---------------------------------------------------------------- params
    def init_params(self, generator: torch.Generator) -> "LlamaModel":
        """Random fp32 weights drawn from ``generator`` on its device, with
        the JAX package's distribution (normal 0.02, residual projections
        scaled by 1/sqrt(2L), unit norm gains). Returns self."""
        c = self.config
        d, i, l = c.n_embd, c.intermediate_size, c.n_layer
        dev = generator.device
        s = 0.02
        proj = s / math.sqrt(2 * l)
        norm = lambda shape, scale: torch.randn(
            shape, generator=generator, device=dev).mul_(scale)
        ones = lambda n: torch.ones(n, device=dev)
        sd = {"wte": norm((c.vocab_size, d), s), "norm_g": ones(d)}
        for n in range(l):
            blk = {"attn_norm_g": ones(d), "q_w": norm((d, d), s),
                   "k_w": norm((d, c.kv_dim), s), "v_w": norm((d, c.kv_dim), s),
                   "o_w": norm((d, d), proj), "mlp_norm_g": ones(d),
                   "gate_w": norm((d, i), s), "up_w": norm((d, i), s),
                   "down_w": norm((i, d), proj)}
            sd.update({f"blocks.{n}.{k}": w for k, w in blk.items()})
        if not c.tie_embeddings:
            sd["lm_head"] = norm((d, c.vocab_size), s)
        self.load_state_dict(sd, assign=True)
        return self

    # --------------------------------------------------------------- compute
    def _head(self, dtype):
        head = self.wte.t() if self.config.tie_embeddings else self.lm_head
        return head.to(dtype)

    def _embed(self, ids):
        return self.wte.to(self.config.dtype)[ids]

    def _rope(self, positions):
        c = self.config
        return _rope_cos_sin(positions, c.head_dim, c.rope_theta, c.rope_scaling)

    def _rms_norm(self, x, g):
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.config.rms_norm_eps) * g).to(x.dtype)

    def _repeat_kv(self, t):
        """(B, T, KV, Dh) → (B, T, H, Dh) for the attention kernel."""
        rep = self.config.n_head // self.config.n_kv_head
        return t if rep == 1 else t.repeat_interleave(rep, dim=2)

    def _block_qkv(self, x, blk: LlamaBlock, cos, sin):
        """One block's RoPE'd q, k, v for the current x."""
        c = self.config
        B, T, _ = x.shape
        hd = self._rms_norm(x, blk.attn_norm_g).to(c.dtype)
        q = (hd @ blk.q_w.to(hd.dtype)).view(B, T, c.n_head, c.head_dim)
        k = (hd @ blk.k_w.to(hd.dtype)).view(B, T, c.n_kv_head, c.head_dim)
        v = (hd @ blk.v_w.to(hd.dtype)).view(B, T, c.n_kv_head, c.head_dim)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def _block_finish(self, x, blk: LlamaBlock, attn):
        B, T, D = x.shape
        x = x + attn.reshape(B, T, D) @ blk.o_w.to(x.dtype)
        h = self._rms_norm(x, blk.mlp_norm_g)
        gate = h @ blk.gate_w.to(h.dtype)
        up = h @ blk.up_w.to(h.dtype)
        return x + (F.silu(gate) * up) @ blk.down_w.to(x.dtype)

    def _prompt_block(self, x, blk: LlamaBlock, cos, sin):
        """One block over a whole prompt → (x, k, v); K/V are repeated to
        the query heads before the flash kernel, as in JAX."""
        q, k, v = self._block_qkv(x, blk, cos, sin)
        attn = local_causal_attention(q, self._repeat_kv(k), self._repeat_kv(v),
                                      self.config.use_flash_attention)
        return self._block_finish(x, blk, attn), k, v

    def apply(self, input_ids):
        """input_ids (B, T) → logits (B, T, V) fp32."""
        T = input_ids.shape[1]
        x = self._embed(input_ids)
        cos, sin = self._rope(torch.arange(T, device=x.device))
        for blk in self.blocks:
            x, _, _ = self._prompt_block(x, blk, cos, sin)
        x = self._rms_norm(x, self.norm_g)
        return (x @ self._head(x.dtype)).float()

    forward = apply

    # ------------------------------------------------------------- inference
    def init_cache(self, batch_size: int, max_len: int) -> Dict[str, torch.Tensor]:
        """KV cache of the KV heads only: (L, B, max_len, KV, Dh), plus the
        next write position ``pos`` as a 0-d int32 tensor on the device."""
        c = self.config
        dev = self.wte.device
        shape = (c.n_layer, batch_size, max_len, c.n_kv_head, c.head_dim)
        return {"k": torch.zeros(shape, dtype=c.dtype, device=dev),
                "v": torch.zeros(shape, dtype=c.dtype, device=dev),
                "pos": torch.zeros((), dtype=torch.int32, device=dev)}

    def prefill(self, input_ids, cache):
        """Process the prompt, fill the cache, return last-position logits.
        The cache's tensors are written in place (JAX builds new ones):
        slots [0, T) of every layer; the rest is left as it is."""
        T = input_ids.shape[1]
        x = self._embed(input_ids)
        cos, sin = self._rope(torch.arange(T, device=x.device))
        for n, blk in enumerate(self.blocks):
            x, k, v = self._prompt_block(x, blk, cos, sin)
            cache["k"][n, :, :T] = k
            cache["v"][n, :, :T] = v
        x = self._rms_norm(x, self.norm_g)
        logits = (x[:, -1] @ self._head(x.dtype)).float()
        pos = torch.full((), T, dtype=torch.int32, device=x.device)
        return logits, {"k": cache["k"], "v": cache["v"], "pos": pos}

    def decode_step(self, token, cache):
        """One token for every sequence: (B,) → logits (B, V), cache
        advanced. Slot ``pos`` is written in place before attending, and the
        position stays on the device: no step waits on the host."""
        c = self.config
        pos = cache["pos"]
        slot = pos.view(1).long()
        x = self._embed(token)[:, None]                      # (B, 1, D)
        cos, sin = self._rope(pos.view(1))
        for n, blk in enumerate(self.blocks):
            q, k, v = self._block_qkv(x, blk, cos, sin)      # q (B, 1, H, Dh)
            k_l, v_l = cache["k"][n], cache["v"][n]
            k_l.index_copy_(1, slot, k.to(k_l.dtype))
            v_l.index_copy_(1, slot, v.to(v_l.dtype))
            attn = cached_decode_attention(q[:, 0], k_l, v_l, pos, c.use_flash_decode)
            x = self._block_finish(x, blk, attn[:, None])
        x = self._rms_norm(x, self.norm_g)
        logits = (x[:, 0] @ self._head(x.dtype)).float()
        return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def params_from_jax(np_params: Mapping[str, Any], config: LlamaConfig) -> LlamaModel:
    """A LlamaModel holding the JAX package's llama params: ``wte``,
    ``norm_g``, optional ``lm_head`` and the layer-stacked ``blocks`` dict
    (``blocks.q_w`` (L, d, d), norms (L, d)), as numpy arrays. The copy is
    exact: same orientation, same type."""
    t = lambda a: torch.tensor(np.asarray(a))
    sd = {"wte": t(np_params["wte"]), "norm_g": t(np_params["norm_g"])}
    if "lm_head" in np_params:
        sd["lm_head"] = t(np_params["lm_head"])
    for key in BLOCK_KEYS:
        stacked = np.asarray(np_params["blocks"][key])
        for n in range(config.n_layer):
            sd[f"blocks.{n}.{key}"] = t(stacked[n])
    model = LlamaModel(config)
    model.load_state_dict(sd, assign=True)
    return model
