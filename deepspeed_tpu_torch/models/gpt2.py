"""GPT-2 family decoder and its variants: training and serving.

Counterpart of ``deepspeed_tpu/models/gpt2.py``: pre-LN blocks with fused
qkv, learned positions, GELU MLP, tied (or separate) LM head, layer norms in
fp32, bf16 compute and an fp32 loss computed in sequence chunks. The JAX
model is functional over a layer-stacked param pytree and scans the layers;
here :class:`GPT2Model` is an ``nn.Module`` with one :class:`GPT2Block` per
layer and a Python loop. Weights keep the JAX orientation (``x @ W``), so
:func:`params_from_jax` copies them exactly.

The config's switches carry the GPT-2 variant families that
``module_inject/hf.py`` loads: ALiBi (BLOOM, no position table, with
``embed_layernorm``), rotary embeddings on the first ``rotary_pct`` of each
head in the rotate-half (GPT-NeoX/Pythia) or interleaved (GPT-J)
convention (no position table), the parallel residual, per-layer
"global"/"local" attention with a sliding ``window_size`` (GPT-Neo), the
ReLU MLP (OPT) and a head bias (GPT-J). The layer loop is a Python loop, so
each layer's window is known on the host: a global layer takes the flash
kernels, a local or ALiBi layer the plain masked attention, as the JAX
dispatch sends it to the einsum.

This port trains: ``init_params`` (and ``param_chunks``, the same draws a
piece at a time), ``apply``, ``hidden_states`` and ``loss`` (and its stages
``embed_stage``, ``_block`` and ``loss_stage``, which the ZeRO-Infinity
engine runs one at a time), with ``remat`` off, "full", "dots", "attn" or
"attn_mlp" (``models/common.py`` ``remat_call``), with dense causal
attention or, when ``sparse_attention`` is set, block-sparse attention
(``ops/sparse_attention``). ``dropout`` (the embedding and both residual
branches) and progressive layer drop (``pld_theta``) draw from the
``generator`` the engine passes: per-site seeds and the layers' gates before
the layer loop, each mask from a generator seeded inside its block, so a
recompute under remat draws the same masks. The engine hands the loss the
same generator on every data-parallel rank and the rank: the seeds are
offset by it, so each rank's rows get masks of their own, while the gates
agree. Without a generator neither applies, as JAX without an rng. It
serves over a KV cache: ``init_cache``, ``prefill`` (the flash kernel,
causal) and ``decode_step`` (the decode kernel with ``use_flash_decode``,
one query head per KV head), each step graph-safe: the position stays on the device, and the rotary tables, the
ALiBi bias and the window mask of a step are computed from it there. A
sparse-trained model is not served (``init_cache`` raises, as in JAX).
Sequence parallelism raises ``NotImplementedError``.

Each module computes with its own parameters through ``_gathered(module)``
(``models/common.py``'s :class:`GatheredModule`): the embedding and the head
are the model's own parameters and gather twice a forward.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.common import (INIT_CHUNK, GatheredModule, _rope_cos_sin,
                                                alibi_slopes, apply_rope, assemble,
                                                cached_decode_attention, causal_attention,
                                                checkpoint_name, chunked_lm_loss, draw_seeds,
                                                dropout, gate_layer, init_pieces, layer_norm,
                                                lm_loss_tokens, local_causal_attention, meta_weight,
                                                parse_lm_batch, pld_gates, remat_call)
from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import MODES as SPARSE_MODES


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: later slice of the port")


@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    # MLP activation (HF naming): 'gelu_new' (tanh approximation, GPT-2's
    # own), 'gelu' (exact erf), 'relu' (OPT) or 'quick_gelu' (CLIP)
    activation: str = "gelu_new"
    dtype: Any = torch.bfloat16      # compute type
    # activation checkpointing: False/'none', True/'full' (recompute each
    # block in the backward), 'dots' (keep the matmul outputs), 'attn' (keep
    # the flash forward's outputs: K1 does not run again in the backward) or
    # 'attn_mlp' (those and the MLP activation)
    remat: Any = True
    # recompute each loss chunk's fp32 logits in the backward instead of
    # keeping them (models/common.py chunked_lm_loss)
    remat_loss_chunks: bool = True
    use_flash_attention: bool = True
    # the TPU kernel's tile edge; the CUDA kernels use fixed tiles
    flash_block: Optional[int] = None
    # the decode-attention kernel in decode_step; off selects the grouped
    # einsum, as in JAX
    use_flash_decode: bool = False
    tie_embeddings: bool = True
    lm_head_bias: bool = False       # GPT-J style bias on the (untied) head
    alibi: bool = False
    embed_layernorm: bool = False    # BLOOM-style layernorm after the embedding
    rotary_pct: float = 0.0
    rotary_theta: float = 10000.0
    rotary_interleaved: bool = False
    parallel_residual: bool = False
    # block-sparse attention (the ds_config "sparse_attention" block):
    # {"mode": "fixed"|"variable"|"bigbird"|"bslongformer"|"dense"|
    # "localslidingwindow", "block": int, ...}, the other keys being keyword
    # arguments of the mode's SparsityConfig. Overrides flash/einsum
    # attention when set.
    sparse_attention: Optional[dict] = None
    sequence_parallel: Any = False
    attention_layers: Optional[tuple] = None
    window_size: int = 256
    # lax.scan unroll factor of the JAX layer loop; the port's layer loop is
    # a Python loop, so it has no effect here
    scan_unroll: int = 1

    VALID_REMAT = (False, None, "none", True, "full", "dots", "attn", "attn_mlp")

    def __post_init__(self):
        if self.remat not in self.VALID_REMAT:
            raise ValueError(f"remat={self.remat!r} not in {self.VALID_REMAT}")
        if self.activation not in ("gelu", "gelu_new", "relu", "quick_gelu"):
            raise ValueError(f"activation {self.activation!r} not in "
                             "('gelu', 'gelu_new', 'relu', 'quick_gelu')")
        if not 0.0 <= self.rotary_pct <= 1.0:
            raise ValueError(f"rotary_pct {self.rotary_pct} not in [0, 1]")
        if self.alibi and self.rotary_pct:
            raise ValueError("alibi and rotary_pct are mutually exclusive "
                             "position mechanisms")
        if self.sparse_attention is not None:
            mode = dict(self.sparse_attention).get("mode", "fixed")
            if mode not in SPARSE_MODES:
                raise ValueError(f"sparse_attention mode {mode!r} unknown")
            if self.sequence_parallel:
                raise NotImplementedError("sparse_attention does not compose with ring/Ulysses "
                                          "sequence parallelism")
            if self.alibi:
                raise NotImplementedError("sparse_attention does not carry ALiBi biases")
        if self.attention_layers is not None:
            self.attention_layers = tuple(self.attention_layers)
            if len(self.attention_layers) != self.n_layer:
                raise ValueError(f"attention_layers has {len(self.attention_layers)} "
                                 f"entries for n_layer={self.n_layer}")
            bad = set(self.attention_layers) - {"global", "local"}
            if bad:
                raise ValueError(f"attention_layers entries {bad} not in ('global', 'local')")
            if "local" in self.attention_layers:
                if self.window_size <= 0:
                    raise ValueError("local attention needs window_size > 0")
                if self.sparse_attention is not None or self.sequence_parallel:
                    raise NotImplementedError("GPT-Neo local attention does not compose with "
                                              "sparse_attention or sequence parallelism")
        # what this slice of the port does not carry raises, never silently
        if self.sequence_parallel:
            raise _later("GPT-2 sequence_parallel")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def num_params(self) -> int:
        d, l, v, t = self.n_embd, self.n_layer, self.vocab_size, self.n_positions
        per_layer = 12 * d * d + 13 * d
        return v * d + t * d + l * per_layer + 2 * d

    def flops_per_token(self, seq_len: Optional[int] = None) -> float:
        """Forward+backward model FLOPs per token: 6N + 12·l·d·s, the
        Megatron accounting; remat recompute is not counted."""
        s = seq_len or self.n_positions
        return 6 * self.num_params() + 12 * self.n_layer * self.n_embd * s


PRESETS = {
    "gpt2-tiny": GPT2Config(vocab_size=2048, n_positions=256, n_embd=128, n_layer=2, n_head=4),
    "gpt2-125m": GPT2Config(n_embd=768, n_layer=12, n_head=12),
    "gpt2-350m": GPT2Config(n_embd=1024, n_layer=24, n_head=16),
    # the canonical 16-head layout (head dim 96)
    "gpt2-760m": GPT2Config(n_embd=1536, n_layer=24, n_head=16),
    "gpt2-1.3b": GPT2Config(n_embd=2048, n_layer=24, n_head=16, n_positions=2048),
    "gpt2-xl": GPT2Config(n_embd=1600, n_layer=48, n_head=25, n_positions=1024),
    "gpt2-2.7b": GPT2Config(n_embd=2560, n_layer=32, n_head=32, n_positions=2048),
    "gpt2-6.7b": GPT2Config(n_embd=4096, n_layer=32, n_head=32, n_positions=2048),
}

# per-layer weights, in the JAX package's ``blocks`` naming
BLOCK_KEYS = ("ln1_g", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
              "ln2_g", "ln2_b", "fc_w", "fc_b", "fc2_w", "fc2_b")


class GPT2Block(nn.Module):
    """One layer's weights (the computation lives on GPT2Model, which
    gathers them around each use)."""

    def __init__(self, c: GPT2Config):
        super().__init__()
        d = c.n_embd
        self.ln1_g, self.ln1_b = meta_weight(d), meta_weight(d)
        self.qkv_w, self.qkv_b = meta_weight(d, 3 * d), meta_weight(3 * d)
        self.proj_w, self.proj_b = meta_weight(d, d), meta_weight(d)
        self.ln2_g, self.ln2_b = meta_weight(d), meta_weight(d)
        self.fc_w, self.fc_b = meta_weight(d, 4 * d), meta_weight(4 * d)
        self.fc2_w, self.fc2_b = meta_weight(4 * d, d), meta_weight(d)


class GPT2Model(GatheredModule):
    def __init__(self, config: GPT2Config):
        super().__init__()
        c = self.config = config
        d = c.n_embd
        self.wte = meta_weight(c.vocab_size, d)
        if self.learned_positions:
            self.wpe = meta_weight(c.n_positions, d)
        if c.embed_layernorm:
            self.emb_ln_g, self.emb_ln_b = meta_weight(d), meta_weight(d)
        self.blocks = nn.ModuleList(GPT2Block(c) for _ in range(c.n_layer))
        self.lnf_g, self.lnf_b = meta_weight(d), meta_weight(d)
        if not c.tie_embeddings:
            self.lm_head = meta_weight(d, c.vocab_size)
            if c.lm_head_bias:
                self.lm_head_b = meta_weight(c.vocab_size)
        self._sparse = None
        self._slopes = {}        # device → the ALiBi slopes there

    @property
    def learned_positions(self) -> bool:
        """A position table (``wpe``), absent under ALiBi or rotary."""
        return not (self.config.alibi or self.config.rotary_pct)

    # ---------------------------------------------------------------- params
    def param_chunks(self, generator: torch.Generator, chunk: Optional[int] = None):
        """The random fp32 initial values, as ``(name, start, values)``:
        elements ``[start, start + len(values))`` of the flattened
        parameter, at most ``chunk`` (``INIT_CHUNK``) at a time, drawn from ``generator`` on
        its device with the JAX package's distribution (normal 0.02,
        positions 0.01, the residual projections scaled by 1/sqrt(2L), unit
        gains, zero biases). Each tensor is drawn in ``chunk``-element
        pieces one after another, the tensors in the order wte, wpe (when
        the model has one), each layer's, the head's; ``init_params``
        assembles the same pieces, so a build that keeps only some of them
        (``runtime/zero/init.py``) holds the same values as the whole tree."""
        c = self.config
        d, l = c.n_embd, c.n_layer
        proj = 0.02 / math.sqrt(2 * l)
        pieces = init_pieces(generator, chunk or INIT_CHUNK)

        yield from pieces("wte", (c.vocab_size, d), 0.02)
        if self.learned_positions:
            yield from pieces("wpe", (c.n_positions, d), 0.01)
        yield from pieces("lnf_g", (d,), fill=1.0)
        yield from pieces("lnf_b", (d,))
        if c.embed_layernorm:
            yield from pieces("emb_ln_g", (d,), fill=1.0)
            yield from pieces("emb_ln_b", (d,))
        for n in range(l):
            for key, shape, scale, fill in (
                    ("ln1_g", (d,), None, 1.0), ("ln1_b", (d,), None, 0.0),
                    ("qkv_w", (d, 3 * d), 0.02, 0.0), ("qkv_b", (3 * d,), None, 0.0),
                    ("proj_w", (d, d), proj, 0.0), ("proj_b", (d,), None, 0.0),
                    ("ln2_g", (d,), None, 1.0), ("ln2_b", (d,), None, 0.0),
                    ("fc_w", (d, 4 * d), 0.02, 0.0), ("fc_b", (4 * d,), None, 0.0),
                    ("fc2_w", (4 * d, d), proj, 0.0), ("fc2_b", (d,), None, 0.0)):
                yield from pieces(f"blocks.{n}.{key}", shape, scale, fill)
        if not c.tie_embeddings:
            yield from pieces("lm_head", (d, c.vocab_size), 0.02)
            if c.lm_head_bias:
                yield from pieces("lm_head_b", (c.vocab_size,))

    def init_params(self, generator: torch.Generator) -> "GPT2Model":
        """Random fp32 weights from ``generator`` on its device: the whole
        tree of ``param_chunks``. Returns self."""
        return assemble(self, self.param_chunks(generator))

    # --------------------------------------------------------------- compute
    _layer_norm = staticmethod(layer_norm)

    def embed_stage(self, top, input_ids, positions=None):
        """Token (+ learned position, unless ALiBi or rotary) embedding, with
        BLOOM's optional post-embedding layernorm, from the top-level weights
        ``top`` (the model, its gathered weights, or any object with those
        attributes). ``positions``: the positions' indices as a device
        tensor, in place of 0..T-1."""
        c = self.config
        x = top.wte.to(c.dtype)[input_ids]
        if self.learned_positions:
            wpe = top.wpe.to(c.dtype)
            x = x + (wpe[:input_ids.shape[1]] if positions is None
                     else wpe.index_select(0, positions))
        if c.embed_layernorm:
            x = self._layer_norm(x, top.emb_ln_g, top.emb_ln_b)
        return x

    def _embed(self, input_ids, positions=None):
        with self._gathered(self) as top:
            return self.embed_stage(top, input_ids, positions)

    def _alibi(self, device):
        """The ALiBi slopes (H,) fp32 on ``device``, made once per device
        (before any CUDA graph captures a step that reads them), or None."""
        if not self.config.alibi:
            return None
        slopes = self._slopes.get(device)
        if slopes is None:
            slopes = self._slopes[device] = alibi_slopes(self.config.n_head).to(device)
        return slopes

    def _window(self, n: int) -> Optional[int]:
        """Layer ``n``'s GPT-Neo window, or None for a global layer."""
        c = self.config
        if c.attention_layers is not None and c.attention_layers[n] == "local":
            return c.window_size
        return None

    def _rope_tables(self, positions):
        """cos/sin (T, rot) for the rotary fraction of each head at the
        ``positions`` (a device tensor), or None without rotary."""
        c = self.config
        if not c.rotary_pct:
            return None
        # round, not int(): converted ratios like 32/96 come back exactly
        rot = round(c.head_dim * c.rotary_pct)
        rot -= rot % 2
        return _rope_cos_sin(positions, rot, c.rotary_theta,
                             interleaved=c.rotary_interleaved)

    def _apply_partial_rope(self, q, k, rope):
        """Rotate the first ``rot`` dims of each head of q and k (NeoX
        rotate-half or GPT-J rotate-every-two), pass the rest through."""
        if rope is None:
            return q, k
        il = self.config.rotary_interleaved
        cos, sin = rope
        rot = cos.shape[-1]
        qr = apply_rope(q[..., :rot], cos, sin, il)
        kr = apply_rope(k[..., :rot], cos, sin, il)
        return torch.cat([qr, q[..., rot:]], dim=-1), torch.cat([kr, k[..., rot:]], dim=-1)

    def _mlp(self, h, w):
        h = h @ w.fc_w.to(h.dtype) + w.fc_b.to(h.dtype)
        act = self.config.activation
        # named so that remat "attn_mlp" keeps the activation
        with checkpoint_name("mlp_act"):
            if act == "relu":
                h = F.relu(h)
            elif act == "quick_gelu":
                h = h * torch.sigmoid(1.702 * h)
            else:
                h = F.gelu(h, approximate="tanh" if act == "gelu_new" else "none")
        return h @ w.fc2_w.to(h.dtype) + w.fc2_b.to(h.dtype)

    def _block_qkv(self, x, w, rope=None):
        """One block's q, k, v (B, T, H, Dh) for ``x`` from its weights ``w``,
        q and k rotated by the ``rope`` tables when given."""
        c = self.config
        B, T, D = x.shape
        h = self._layer_norm(x, w.ln1_g, w.ln1_b)
        qkv = h @ w.qkv_w.to(h.dtype) + w.qkv_b.to(h.dtype)
        q, k, v = (t.reshape(B, T, c.n_head, c.head_dim) for t in qkv.split(D, dim=-1))
        q, k = self._apply_partial_rope(q, k, rope)
        return q, k, v

    def _block_finish(self, x, w, attn, seeds=None):
        """The attention's projection and residual, then the MLP's (both
        branches on the block input under ``parallel_residual``), each
        branch's dropout drawn from its seed of ``seeds`` (None: none)."""
        B, T, D = x.shape
        c = self.config
        s_attn, s_mlp = seeds if seeds is not None else (None, None)
        a = attn.reshape(B, T, D) @ w.proj_w.to(x.dtype) + w.proj_b.to(x.dtype)
        if c.parallel_residual:
            # NeoX: x + attn(ln1(x)) + mlp(ln2(x))
            h = self._layer_norm(x, w.ln2_g, w.ln2_b)
            return x + dropout(a, c.dropout, s_attn) + dropout(self._mlp(h, w), c.dropout,
                                                                s_mlp)
        x = x + dropout(a, c.dropout, s_attn)
        h = self._layer_norm(x, w.ln2_g, w.ln2_b)
        return x + dropout(self._mlp(h, w), c.dropout, s_mlp)

    def _layer_finish(self, n: int, x, w, attn):
        """Layer ``n``'s finish after its attention in the serving walk
        (``MoEGPT2`` runs its odd layers' MLP through the expert bank)."""
        return self._block_finish(x, w, attn)

    def _attention(self, q, k, v, n: int):
        """Layer ``n``'s causal attention over the whole sequence: the
        block-sparse layout when configured, else the dense dispatch with the
        model's ALiBi slopes and the layer's window."""
        c = self.config
        if c.sparse_attention is not None:
            return self._sparse_attention(q, k, v)
        return causal_attention(q, k, v, use_flash=c.use_flash_attention,
                                sequence_parallel=c.sequence_parallel,
                                alibi=self._alibi(q.device), window=self._window(n))

    def _block(self, x, blk: GPT2Block, n: int = 0, rope=None, seeds=None):
        """Layer ``n`` (``blk``) over the whole sequence. ``rope``: the
        rotary tables of positions 0..T-1 (made here when None); ``seeds``:
        the layer's two dropout seeds (None: no dropout)."""
        with self._gathered(blk) as w:
            if rope is None:
                rope = self._rope_tables(torch.arange(x.shape[1], device=x.device))
            q, k, v = self._block_qkv(x, w, rope)
            return self._block_finish(x, w, self._attention(q, k, v, n), seeds)

    def _sparse_attention(self, q, k, v):
        """Causal block-sparse attention of the config's ``sparse_attention``
        block, its ``SparseSelfAttention`` built at first use: the kernels
        on CUDA tensors, their plain versions on CPU tensors."""
        if self._sparse is None:
            self._sparse = sparse_self_attention(self.config.sparse_attention,
                                                 self.config.n_head)
        return self._sparse(q, k, v, causal=True)

    def _blocks(self, input_ids, generator: Optional[torch.Generator] = None, pld_theta=None,
                dropout_rank: int = 0):
        """Embedding and every block: (B, T) → (B, T, D) before the final
        layer norm. With ``generator``: dropout (one seed per site, drawn
        here and offset by the data-parallel ``dropout_rank``) and, with
        ``pld_theta`` too, progressive layer drop's gates (the same on
        every rank)."""
        c = self.config
        L = c.n_layer
        x = self._embed(input_ids)
        seeds = None
        if generator is not None and c.dropout > 0.0:
            seeds = draw_seeds(generator, 1 + 2 * L, dropout_rank)
            x = dropout(x, c.dropout, seeds[0])
        gates = pld_gates(pld_theta, L, generator) \
            if pld_theta is not None and generator is not None else None
        rope = self._rope_tables(torch.arange(input_ids.shape[1], device=x.device))
        for n, blk in enumerate(self.blocks):
            y = remat_call(c.remat, self._block, x, blk, n, rope,
                           None if seeds is None else seeds[1 + 2 * n:3 + 2 * n])
            x = gate_layer(x, y, None if gates is None else gates[n])
        return x

    def _head(self, top, dtype):
        head = top.wte.t() if self.config.tie_embeddings else top.lm_head
        return head.to(dtype)

    def _head_bias(self, top):
        c = self.config
        return top.lm_head_b if not c.tie_embeddings and c.lm_head_bias else None

    def hidden_states(self, input_ids, generator: Optional[torch.Generator] = None):
        """Transformer trunk only: (B, T) → final hidden (B, T, D)."""
        x = self._blocks(input_ids, generator)
        with self._gathered(self) as top:
            return self._layer_norm(x, top.lnf_g, top.lnf_b)

    def _lm_logits(self, x):
        """The final layer norm and the head: hidden (..., D) → fp32 logits."""
        with self._gathered(self) as top:
            x = self._layer_norm(x, top.lnf_g, top.lnf_b)
            logits = (x @ self._head(top, x.dtype)).float()
            bias = self._head_bias(top)
            return logits if bias is None else logits + bias.float()

    def apply(self, input_ids, generator: Optional[torch.Generator] = None):
        """input_ids (B, T) → logits (B, T, V) fp32; ``generator`` draws the
        dropout masks."""
        return self._lm_logits(self._blocks(input_ids, generator))

    forward = apply

    def loss_stage(self, top, x, batch):
        """The final layer norm and the chunked LM loss of the trunk's
        output ``x`` (B, T, D) against ``batch``'s targets, from the
        top-level weights ``top`` (the JAX pipeline's
        ``_last_stage_loss_fn``)."""
        _, labels, mask = parse_lm_batch(batch)
        x = self._layer_norm(x, top.lnf_g, top.lnf_b)[:, :-1]             # (B, T-1, D)
        return chunked_lm_loss(x, self._head(top, x.dtype), labels[:, 1:],
                               mask[:, 1:] if mask is not None else None,
                               bias=self._head_bias(top), remat=self.config.remat_loss_chunks)

    def loss(self, batch, generator: Optional[torch.Generator] = None, pld_theta=None,
             dropout_rank: int = 0):
        """batch: dict with input_ids (B, T) [+ optional labels/loss_mask]
        or a bare (B, T) tensor → mean next-token cross entropy (fp32). The
        vocab projection runs in sequence chunks, so the (B, T, V) fp32
        logits are never held at once. ``generator``: the engine's, for
        dropout and the PLD gates; ``pld_theta``: progressive layer drop's
        keep probability θ (None: every block runs); ``dropout_rank``: this
        process's data-parallel rank, which offsets the dropout seeds."""
        ids, _, _ = parse_lm_batch(batch)
        x = self._blocks(ids, generator, pld_theta, dropout_rank)
        with self._gathered(self) as top:
            return self.loss_stage(top, x, batch)

    def loss_tokens(self, batch):
        """What :meth:`loss` averages over: the masked target count, or None
        without a mask (the engine weights ranks' losses by it)."""
        return lm_loss_tokens(batch)

    # ------------------------------------------------------------- inference
    def init_cache(self, batch_size: int, max_len: int,
                   device=None) -> Dict[str, torch.Tensor]:
        """KV cache: (L, B, max_len, H, Dh) per k and v, plus the next write
        position ``pos`` as a 0-d int32 tensor on the device
        (``device``, default the model's: ``"meta"`` sizes it without
        allocating)."""
        c = self.config
        if c.sparse_attention is not None:
            # prefill and decode attend densely over the cache; serving a
            # sparse-trained model that way would silently mismatch the
            # trained attention distribution
            raise NotImplementedError(
                "KV-cache generation does not apply sparse_attention "
                "layouts; serve with sparse_attention=None only if the "
                "model was also trained dense")
        dev = self.wte.device if device is None else device
        shape = (c.n_layer, batch_size, max_len, c.n_head, c.head_dim)
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
        rope = self._rope_tables(torch.arange(T, device=x.device))
        alibi = self._alibi(x.device)
        for n, blk in enumerate(self.blocks):
            with self._gathered(blk) as w:
                q, k, v = self._block_qkv(x, w, rope)
                attn = local_causal_attention(q, k, v, c.use_flash_attention, alibi=alibi,
                                              window=self._window(n))
                x = self._layer_finish(n, x, w, attn)
            cache["k"][n, :, :T] = k
            cache["v"][n, :, :T] = v
        logits = self._lm_logits(x[:, -1])
        pos = torch.full((), T, dtype=torch.int32, device=x.device)
        return logits, {"k": cache["k"], "v": cache["v"], "pos": pos}

    def _decode_embed(self, token, pos):
        """(B,) tokens at the 0-d device position ``pos`` → (B, 1, D); the
        learned position is an ``index_select`` by the device tensor, so a
        captured step reads the position of its replay."""
        return self._embed(token[:, None], pos.view(1).long())

    def decode_step(self, token, cache):
        """One token for every sequence: (B,) → logits (B, V), cache
        advanced. Slot ``pos`` is written in place before attending, and the
        position stays on the device: no step waits on the host. The rotary
        tables, the ALiBi bias and the window mask come from ``pos`` there."""
        c = self.config
        pos = cache["pos"]
        slot = pos.view(1).long()
        x = self._decode_embed(token, pos)                   # (B, 1, D)
        rope = self._rope_tables(pos.view(1))
        alibi = self._alibi(x.device)
        for n, blk in enumerate(self.blocks):
            with self._gathered(blk) as w:
                q, k, v = self._block_qkv(x, w, rope)        # (B, 1, H, Dh)
                k_l, v_l = cache["k"][n], cache["v"][n]
                k_l.index_copy_(1, slot, k.to(k_l.dtype))
                v_l.index_copy_(1, slot, v.to(v_l.dtype))
                # q is a view of the fused qkv projection; the decode
                # kernel takes contiguous rows
                attn = cached_decode_attention(q[:, 0].contiguous(), k_l, v_l, pos,
                                               c.use_flash_decode, alibi=alibi,
                                               window=self._window(n))
                x = self._layer_finish(n, x, w, attn[:, None])
        logits = self._lm_logits(x[:, 0])
        return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def synthetic_lm_batch(batch_size: int, seq_len: int, vocab_size: int, seed: int = 0,
                       device=None):
    """Random token ids from a torch generator seeded with ``seed``, made on
    ``device`` (the JAX package draws them with numpy; the two streams
    differ)."""
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    return {"input_ids": torch.randint(0, vocab_size, (batch_size, seq_len), generator=gen,
                                       device=device)}


def params_from_jax(np_params: Mapping[str, Any], config: GPT2Config) -> GPT2Model:
    """A GPT2Model holding the JAX package's GPT-2 params (``wte``, ``lnf_*``,
    the layer-stacked ``blocks`` dict and the optional ``wpe`` (absent under
    ALiBi or rotary), ``emb_ln_*``, ``lm_head``, ``lm_head_b``), as numpy
    arrays. Stacked
    (L, ...) block leaves become per-layer weights; the copy is exact."""
    t = lambda a: torch.tensor(np.asarray(a))
    sd = {k: t(v) for k, v in np_params.items() if k != "blocks"}
    for key in BLOCK_KEYS:
        stacked = np.asarray(np_params["blocks"][key])
        for n in range(config.n_layer):
            sd[f"blocks.{n}.{key}"] = t(stacked[n])
    model = GPT2Model(config)
    model.load_state_dict(sd, assign=True)
    return model
