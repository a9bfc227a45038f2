"""LLaMA family decoder: training and serving.

Counterpart of ``deepspeed_tpu/models/llama.py``: RMSNorm and RoPE in fp32,
SwiGLU MLP without biases, grouped-query attention whose KV cache holds only
the KV heads, tied or separate LM head, bf16 compute and an fp32 loss
computed in sequence chunks. The JAX model is functional over a stacked
param pytree and scans the layers; here :class:`LlamaModel` is an
``nn.Module`` with one :class:`LlamaBlock` per layer and a Python loop.
Weights keep the JAX orientation (``x @ W``, ``q_w`` is (d, d)), so
:func:`params_from_jax` copies them exactly.

It trains: ``init_params`` (and ``param_chunks``, the same draws a piece at
a time), ``apply``, ``hidden_states``, ``loss`` and ``loss_tokens``, with
``remat`` off, "full", "dots" or "attn" (``models/common.py``
``remat_call``: "attn" keeps the flash forward's outputs, so the backward
does not launch it again). The KV heads
are repeated to the query heads before the flash kernel, as in JAX, and the
repeat stays in the autograd graph, so each KV head's gradient is the sum
over its group of query heads. It serves over a KV cache of the KV heads:
``init_cache``, ``prefill`` and ``decode_step``, each step graph-safe. Each
module computes with its own parameters through ``_gathered(module)``
(``models/common.py``'s :class:`GatheredModule`), so ZeRO stage 3 and
``offload_param`` apply; a tied ``wte`` gathers for the embedding and again
for the head. Sequence parallelism raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.common import (GatheredModule, _rope_cos_sin, apply_rope,
                                               assemble, cached_decode_attention,
                                               causal_attention, chunked_lm_loss,
                                               init_pieces, lm_loss_tokens,
                                               local_causal_attention, meta_weight,
                                               parse_lm_batch, remat_call)


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
    # recompute each loss chunk's fp32 logits in the backward instead of
    # keeping them (models/common.py chunked_lm_loss)
    remat_loss_chunks: bool = True
    tie_embeddings: bool = False     # llama3.2-1B/3B style tied lm_head
    dtype: Any = torch.bfloat16      # compute and KV-cache type
    # activation checkpointing: False/'none', True/'full' (recompute each
    # block in the backward), 'dots' (keep the matmul outputs) or 'attn'
    # (keep the flash forward's outputs: K1 does not run again)
    remat: Any = True
    use_flash_attention: bool = True
    # the decode-attention kernel; off selects the grouped einsum, as in JAX
    use_flash_decode: bool = False
    sequence_parallel: Any = False   # 'ring' / 'ulysses' are later slices

    VALID_REMAT = (False, None, "none", True, "full", "dots", "attn")

    VALID_ROPE_TYPES = ("default", "linear", "llama3")

    def __post_init__(self):
        if self.remat not in self.VALID_REMAT:
            raise ValueError(f"remat={self.remat!r} not in {self.VALID_REMAT}")
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
        # what this slice of the port does not carry raises, never silently
        if self.sequence_parallel:
            raise NotImplementedError("llama sequence_parallel: later slice of the port")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_head * self.head_dim

    def num_params(self) -> int:
        d, i, l, v = self.n_embd, self.intermediate_size, self.n_layer, self.vocab_size
        per_layer = d * d + 2 * d * self.kv_dim + d * d + 3 * d * i + 2 * d
        embeds = v * d if self.tie_embeddings else 2 * v * d
        return embeds + l * per_layer + d

    def flops_per_token(self, seq_len: Optional[int] = None) -> float:
        """Forward+backward model FLOPs per token: 6N + 12·l·d·s, the
        Megatron accounting, as in GPT2Config (GQA changes only the KV
        projection, already inside N); remat recompute is not counted."""
        s = seq_len or self.n_positions
        return 6 * self.num_params() + 12 * self.n_layer * self.n_embd * s


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


class LlamaBlock(nn.Module):
    """One decoder layer's weights (the computation lives on LlamaModel,
    which gathers them around each use)."""

    def __init__(self, c: LlamaConfig):
        super().__init__()
        d, i = c.n_embd, c.intermediate_size
        self.attn_norm_g = meta_weight(d)
        self.q_w = meta_weight(d, d)
        self.k_w = meta_weight(d, c.kv_dim)
        self.v_w = meta_weight(d, c.kv_dim)
        self.o_w = meta_weight(d, d)
        self.mlp_norm_g = meta_weight(d)
        self.gate_w = meta_weight(d, i)
        self.up_w = meta_weight(d, i)
        self.down_w = meta_weight(i, d)


class LlamaModel(GatheredModule):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        c = self.config = config
        self.wte = meta_weight(c.vocab_size, c.n_embd)
        self.blocks = nn.ModuleList(LlamaBlock(c) for _ in range(c.n_layer))
        self.norm_g = meta_weight(c.n_embd)
        if not c.tie_embeddings:
            self.lm_head = meta_weight(c.n_embd, c.vocab_size)

    # ---------------------------------------------------------------- params
    def param_chunks(self, generator: torch.Generator, chunk: Optional[int] = None):
        """The random fp32 initial values, as ``(name, start, values)``
        pieces of at most ``chunk`` elements (``models/common.py``
        :func:`init_pieces`), drawn from ``generator`` on its device with the
        JAX package's distribution (normal 0.02, the residual projections
        ``o_w`` and ``down_w`` scaled by 1/sqrt(2L), unit norm gains), in the
        order wte, norm_g, each layer's, the head's. ``init_params``
        assembles the same pieces, so a build that keeps only some of them
        (``runtime/zero/init.py``) holds the same values as the whole
        tree."""
        c = self.config
        d, i, l = c.n_embd, c.intermediate_size, c.n_layer
        s = 0.02
        proj = s / math.sqrt(2 * l)
        pieces = init_pieces(generator, chunk)
        yield from pieces("wte", (c.vocab_size, d), s)
        yield from pieces("norm_g", (d,), fill=1.0)
        for n in range(l):
            for key, shape, scale, fill in (
                    ("attn_norm_g", (d,), None, 1.0), ("q_w", (d, d), s, 0.0),
                    ("k_w", (d, c.kv_dim), s, 0.0), ("v_w", (d, c.kv_dim), s, 0.0),
                    ("o_w", (d, d), proj, 0.0), ("mlp_norm_g", (d,), None, 1.0),
                    ("gate_w", (d, i), s, 0.0), ("up_w", (d, i), s, 0.0),
                    ("down_w", (i, d), proj, 0.0)):
                yield from pieces(f"blocks.{n}.{key}", shape, scale, fill)
        if not c.tie_embeddings:
            yield from pieces("lm_head", (d, c.vocab_size), s)

    def init_params(self, generator: torch.Generator) -> "LlamaModel":
        """Random fp32 weights from ``generator`` on its device: the whole
        tree of ``param_chunks``. Returns self."""
        return assemble(self, self.param_chunks(generator))

    # --------------------------------------------------------------- compute
    def _head(self, top, dtype):
        head = top.wte.t() if self.config.tie_embeddings else top.lm_head
        return head.to(dtype)

    def _embed(self, ids):
        with self._gathered(self) as top:
            return top.wte.to(self.config.dtype)[ids]

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

    def _block_qkv(self, x, w, cos, sin):
        """One block's RoPE'd q, k, v for the current x, from its weights
        ``w``."""
        c = self.config
        B, T, _ = x.shape
        hd = self._rms_norm(x, w.attn_norm_g).to(c.dtype)
        q = (hd @ w.q_w.to(hd.dtype)).view(B, T, c.n_head, c.head_dim)
        k = (hd @ w.k_w.to(hd.dtype)).view(B, T, c.n_kv_head, c.head_dim)
        v = (hd @ w.v_w.to(hd.dtype)).view(B, T, c.n_kv_head, c.head_dim)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def _block_finish(self, x, w, attn):
        B, T, D = x.shape
        x = x + attn.reshape(B, T, D) @ w.o_w.to(x.dtype)
        h = self._rms_norm(x, w.mlp_norm_g)
        gate = h @ w.gate_w.to(h.dtype)
        up = h @ w.up_w.to(h.dtype)
        return x + (F.silu(gate) * up) @ w.down_w.to(x.dtype)

    def _block(self, x, blk: LlamaBlock, cos, sin):
        """One block over the whole sequence; K/V are repeated to the query
        heads before the attention, as in JAX."""
        c = self.config
        with self._gathered(blk) as w:
            q, k, v = self._block_qkv(x, w, cos, sin)
            attn = causal_attention(q, self._repeat_kv(k), self._repeat_kv(v),
                                    use_flash=c.use_flash_attention,
                                    sequence_parallel=c.sequence_parallel)
            return self._block_finish(x, w, attn)

    def _blocks(self, input_ids):
        """Embedding and every block: (B, T) → (B, T, D) before the final
        norm."""
        T = input_ids.shape[1]
        x = self._embed(input_ids)
        cos, sin = self._rope(torch.arange(T, device=x.device))
        for blk in self.blocks:
            x = remat_call(self.config.remat, self._block, x, blk, cos, sin)
        return x

    def _lm_logits(self, x):
        """The final norm and the head: hidden (..., D) → fp32 logits."""
        with self._gathered(self) as top:
            x = self._rms_norm(x, top.norm_g)
            return (x @ self._head(top, x.dtype)).float()

    def hidden_states(self, input_ids):
        """Transformer trunk only: (B, T) → final hidden (B, T, D)."""
        x = self._blocks(input_ids)
        with self._gathered(self) as top:
            return self._rms_norm(x, top.norm_g)

    def apply(self, input_ids):
        """input_ids (B, T) → logits (B, T, V) fp32."""
        return self._lm_logits(self._blocks(input_ids))

    forward = apply

    def loss(self, batch):
        """batch: dict with input_ids (B, T) [+ optional labels/loss_mask]
        or a bare (B, T) tensor → mean next-token cross entropy (fp32), the
        vocab projection in sequence chunks (``chunked_lm_loss``)."""
        ids, labels, mask = parse_lm_batch(batch)
        x = self._blocks(ids)
        with self._gathered(self) as top:
            x = self._rms_norm(x, top.norm_g)[:, :-1]                     # (B, T-1, D)
            return chunked_lm_loss(x, self._head(top, x.dtype), labels[:, 1:],
                                   mask[:, 1:] if mask is not None else None,
                                   remat=self.config.remat_loss_chunks)

    def loss_tokens(self, batch):
        """What :meth:`loss` averages over: the masked target count, or None
        without a mask (the engine weights ranks' losses by it)."""
        return lm_loss_tokens(batch)

    # ------------------------------------------------------------- inference
    def init_cache(self, batch_size: int, max_len: int,
                   device=None) -> Dict[str, torch.Tensor]:
        """KV cache of the KV heads only: (L, B, max_len, KV, Dh), plus the
        next write position ``pos`` as a 0-d int32 tensor on the device
        (``device``, default the model's: ``"meta"`` sizes it without
        allocating)."""
        c = self.config
        dev = self.wte.device if device is None else device
        shape = (c.n_layer, batch_size, max_len, c.n_kv_head, c.head_dim)
        return {"k": torch.zeros(shape, dtype=c.dtype, device=dev),
                "v": torch.zeros(shape, dtype=c.dtype, device=dev),
                "pos": torch.zeros((), dtype=torch.int32, device=dev)}

    def prefill(self, input_ids, cache):
        """Process the prompt, fill the cache, return last-position logits.
        The cache's tensors are written in place (JAX builds new ones):
        slots [0, T) of every layer; the rest is left as it is."""
        c = self.config
        T = input_ids.shape[1]
        x = self._embed(input_ids)
        cos, sin = self._rope(torch.arange(T, device=x.device))
        for n, blk in enumerate(self.blocks):
            with self._gathered(blk) as w:
                q, k, v = self._block_qkv(x, w, cos, sin)
                attn = local_causal_attention(q, self._repeat_kv(k), self._repeat_kv(v),
                                              c.use_flash_attention)
                x = self._block_finish(x, w, attn)
            cache["k"][n, :, :T] = k
            cache["v"][n, :, :T] = v
        logits = self._lm_logits(x[:, -1])
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
            with self._gathered(blk) as w:
                q, k, v = self._block_qkv(x, w, cos, sin)    # q (B, 1, H, Dh)
                k_l, v_l = cache["k"][n], cache["v"][n]
                k_l.index_copy_(1, slot, k.to(k_l.dtype))
                v_l.index_copy_(1, slot, v.to(v_l.dtype))
                attn = cached_decode_attention(q[:, 0], k_l, v_l, pos, c.use_flash_decode)
                x = self._block_finish(x, w, attn[:, None])
        logits = self._lm_logits(x[:, 0])
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
