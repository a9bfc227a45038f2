"""GPT-2 family decoder, training path.

Counterpart of ``deepspeed_tpu/models/gpt2.py``: pre-LN blocks with fused
qkv, learned positions, GELU MLP, tied (or separate) LM head, layer norms in
fp32, bf16 compute and an fp32 loss computed in sequence chunks. The JAX
model is functional over a layer-stacked param pytree and scans the layers;
here :class:`GPT2Model` is an ``nn.Module`` with one :class:`GPT2Block` per
layer and a Python loop. Weights keep the JAX orientation (``x @ W``), so
:func:`params_from_jax` copies them exactly.

This port trains: ``init_params`` (and ``param_chunks``, the same draws a
piece at a time), ``apply``, ``hidden_states`` and ``loss`` (and its stages
``embed_stage``, ``_block`` and ``loss_stage``, which the ZeRO-Infinity
engine runs one at a time), with ``remat`` off or "full" (``torch.utils.checkpoint`` per
block), with dense causal attention or, when ``sparse_attention`` is set,
block-sparse attention (``ops/sparse_attention``). The variants the JAX model
also carries (ALiBi, rotary, parallel residual, local attention, sequence
parallelism, dropout, the "dots"/"attn"/"attn_mlp" remat policies and
progressive layer drop) raise ``NotImplementedError``; serving GPT-2 (KV
cache) is a later slice.

Each module computes with its own parameters through ``_gathered(module)``:
the module itself, or, when the engine trains under ZeRO stage 3 and has
set ``param_gatherer``, the parameters gathered just before the module runs
and released after it (``runtime/zero/state.py``). The embedding and the
head are the model's own parameters and gather twice a forward; a block
under ``remat`` gathers again when it is recomputed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.models.common import (causal_attention, chunked_lm_loss,
                                                lm_loss_tokens, parse_lm_batch)
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
    # activation checkpointing: False/'none' or True/'full' (recompute each
    # block in the backward); 'dots', 'attn', 'attn_mlp' are later slices
    remat: Any = True
    # recompute each loss chunk's fp32 logits in the backward instead of
    # keeping them (models/common.py chunked_lm_loss)
    remat_loss_chunks: bool = True
    use_flash_attention: bool = True
    # the TPU kernel's tile edge; the CUDA kernels use fixed tiles
    flash_block: Optional[int] = None
    use_flash_decode: bool = False   # serving (later slice)
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
            if "local" in self.attention_layers and (self.sparse_attention is not None
                                                     or self.sequence_parallel):
                raise NotImplementedError("GPT-Neo local attention does not compose with "
                                          "sparse_attention or sequence parallelism")
        # what this slice of the port does not carry raises, never silently
        if self.remat in ("dots", "attn", "attn_mlp"):
            raise _later(f"remat={self.remat!r} (saving named activations)")
        for name, on in (("alibi", self.alibi), ("rotary_pct", self.rotary_pct),
                         ("parallel_residual", self.parallel_residual),
                         ("sequence_parallel", self.sequence_parallel),
                         ("attention_layers", self.attention_layers is not None),
                         ("dropout", self.dropout),
                         ("flash_block", self.flash_block is not None)):
            if on:
                raise _later(f"GPT-2 {name}")

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

# elements per piece of a random initial tensor (``GPT2Model.param_chunks``)
INIT_CHUNK = 1 << 24

# per-layer weights, in the JAX package's ``blocks`` naming
BLOCK_KEYS = ("ln1_g", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
              "ln2_g", "ln2_b", "fc_w", "fc_b", "fc2_w", "fc2_b")


def _weight(*shape) -> nn.Parameter:
    # allocated on the meta device: a model holds no memory until
    # init_params, params_from_jax or load_state_dict(assign=True) fills it
    return nn.Parameter(torch.empty(*shape, device="meta"))


class GPT2Block(nn.Module):
    """One layer's weights (the computation lives on GPT2Model, which
    gathers them around each use)."""

    def __init__(self, c: GPT2Config):
        super().__init__()
        d = c.n_embd
        self.ln1_g, self.ln1_b = _weight(d), _weight(d)
        self.qkv_w, self.qkv_b = _weight(d, 3 * d), _weight(3 * d)
        self.proj_w, self.proj_b = _weight(d, d), _weight(d)
        self.ln2_g, self.ln2_b = _weight(d), _weight(d)
        self.fc_w, self.fc_b = _weight(d, 4 * d), _weight(4 * d)
        self.fc2_w, self.fc2_b = _weight(4 * d, d), _weight(d)


class GPT2Model(nn.Module):
    def __init__(self, config: GPT2Config):
        super().__init__()
        c = self.config = config
        d = c.n_embd
        self.wte = _weight(c.vocab_size, d)
        self.wpe = _weight(c.n_positions, d)
        if c.embed_layernorm:
            self.emb_ln_g, self.emb_ln_b = _weight(d), _weight(d)
        self.blocks = nn.ModuleList(GPT2Block(c) for _ in range(c.n_layer))
        self.lnf_g, self.lnf_b = _weight(d), _weight(d)
        if not c.tie_embeddings:
            self.lm_head = _weight(d, c.vocab_size)
            if c.lm_head_bias:
                self.lm_head_b = _weight(c.vocab_size)
        self._sparse = None
        # set by the engine under ZeRO stage 3: gather(module) / release(module)
        self.param_gatherer = None

    # ---------------------------------------------------------------- params
    def param_chunks(self, generator: torch.Generator, chunk: Optional[int] = None):
        """The random fp32 initial values, as ``(name, start, values)``:
        elements ``[start, start + len(values))`` of the flattened
        parameter, at most ``chunk`` (``INIT_CHUNK``) at a time, drawn from ``generator`` on
        its device with the JAX package's distribution (normal 0.02,
        positions 0.01, the residual projections scaled by 1/sqrt(2L), unit
        gains, zero biases). Each tensor is drawn in ``chunk``-element
        pieces one after another, the tensors in the order wte, wpe, each
        layer's, the head's; ``init_params`` assembles the same pieces, so a
        build that keeps only some of them (``runtime/zero/init.py``) holds
        the same values as the whole tree."""
        c = self.config
        d, l = c.n_embd, c.n_layer
        dev = generator.device
        proj = 0.02 / math.sqrt(2 * l)
        chunk = chunk or INIT_CHUNK

        def pieces(name, shape, scale=None, fill=0.0):
            n = math.prod(shape)
            for start in range(0, n, chunk):
                m = min(chunk, n - start)
                yield name, start, (torch.randn(m, generator=generator, device=dev).mul_(scale)
                                    if scale is not None
                                    else torch.full((m,), fill, device=dev))

        yield from pieces("wte", (c.vocab_size, d), 0.02)
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
        shapes = {n: p.shape for n, p in self.named_parameters()}
        sd = {}
        for name, start, values in self.param_chunks(generator):
            if name not in sd:
                sd[name] = torch.empty(shapes[name], device=values.device)
            sd[name].view(-1)[start:start + values.numel()] = values
        self.load_state_dict(sd, assign=True)
        return self

    # --------------------------------------------------------------- compute
    @staticmethod
    def _layer_norm(x, g, b, eps: float = 1e-5):
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        return (y * g + b).to(x.dtype)

    @contextlib.contextmanager
    def _gathered(self, module: nn.Module):
        """``module``'s own parameters to compute with (attribute access)."""
        gatherer = self.param_gatherer
        if gatherer is None:
            yield module
            return
        try:
            yield gatherer.gather(module)
        finally:
            gatherer.release(module)

    def embed_stage(self, top, input_ids):
        """Token + learned position embedding, with BLOOM's optional
        post-embedding layernorm, from the top-level weights ``top`` (the
        model, its gathered weights, or any object with those attributes)."""
        c = self.config
        T = input_ids.shape[1]
        x = top.wte.to(c.dtype)[input_ids] + top.wpe.to(c.dtype)[:T]
        if c.embed_layernorm:
            x = self._layer_norm(x, top.emb_ln_g, top.emb_ln_b)
        return x

    def _embed(self, input_ids):
        with self._gathered(self) as top:
            return self.embed_stage(top, input_ids)

    def _mlp(self, h, w):
        h = h @ w.fc_w.to(h.dtype) + w.fc_b.to(h.dtype)
        act = self.config.activation
        if act == "relu":
            h = F.relu(h)
        elif act == "quick_gelu":
            h = h * torch.sigmoid(1.702 * h)
        else:
            h = F.gelu(h, approximate="tanh" if act == "gelu_new" else "none")
        return h @ w.fc2_w.to(h.dtype) + w.fc2_b.to(h.dtype)

    def _block(self, x, blk: GPT2Block):
        c = self.config
        B, T, D = x.shape
        with self._gathered(blk) as w:
            h = self._layer_norm(x, w.ln1_g, w.ln1_b)
            qkv = h @ w.qkv_w.to(h.dtype) + w.qkv_b.to(h.dtype)
            q, k, v = (t.reshape(B, T, c.n_head, c.head_dim) for t in qkv.split(D, dim=-1))
            if c.sparse_attention is not None:
                attn = self._sparse_attention(q, k, v)
            else:
                attn = causal_attention(q, k, v, use_flash=c.use_flash_attention,
                                        sequence_parallel=c.sequence_parallel)
            x = x + (attn.reshape(B, T, D) @ w.proj_w.to(x.dtype) + w.proj_b.to(x.dtype))
            h = self._layer_norm(x, w.ln2_g, w.ln2_b)
            return x + self._mlp(h, w)

    def _sparse_attention(self, q, k, v):
        """Causal block-sparse attention of the config's ``sparse_attention``
        block, its ``SparseSelfAttention`` built at first use: the kernels
        on CUDA tensors, their plain versions on CPU tensors."""
        if self._sparse is None:
            self._sparse = sparse_self_attention(self.config.sparse_attention,
                                                 self.config.n_head)
        return self._sparse(q, k, v, causal=True)

    def _blocks(self, input_ids):
        """Embedding and every block: (B, T) → (B, T, D) before the final
        layer norm."""
        x = self._embed(input_ids)
        remat = self.config.remat in (True, "full")
        for blk in self.blocks:
            x = checkpoint(self._block, x, blk, use_reentrant=False) if remat \
                else self._block(x, blk)
        return x

    def _head(self, top, dtype):
        head = top.wte.t() if self.config.tie_embeddings else top.lm_head
        return head.to(dtype)

    def _head_bias(self, top):
        c = self.config
        return top.lm_head_b if not c.tie_embeddings and c.lm_head_bias else None

    def hidden_states(self, input_ids):
        """Transformer trunk only: (B, T) → final hidden (B, T, D)."""
        x = self._blocks(input_ids)
        with self._gathered(self) as top:
            return self._layer_norm(x, top.lnf_g, top.lnf_b)

    def apply(self, input_ids):
        """input_ids (B, T) → logits (B, T, V) fp32."""
        x = self._blocks(input_ids)
        with self._gathered(self) as top:
            x = self._layer_norm(x, top.lnf_g, top.lnf_b)
            logits = (x @ self._head(top, x.dtype)).float()
            bias = self._head_bias(top)
            return logits if bias is None else logits + bias.float()

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

    def loss(self, batch):
        """batch: dict with input_ids (B, T) [+ optional labels/loss_mask]
        or a bare (B, T) tensor → mean next-token cross entropy (fp32). The
        vocab projection runs in sequence chunks, so the (B, T, V) fp32
        logits are never held at once."""
        ids, _, _ = parse_lm_batch(batch)
        x = self._blocks(ids)
        with self._gathered(self) as top:
            return self.loss_stage(top, x, batch)

    def loss_tokens(self, batch):
        """What :meth:`loss` averages over: the masked target count, or None
        without a mask (the engine weights ranks' losses by it)."""
        return lm_loss_tokens(batch)


def synthetic_lm_batch(batch_size: int, seq_len: int, vocab_size: int, seed: int = 0,
                       device=None):
    """Random token ids from a torch generator seeded with ``seed``, made on
    ``device`` (the JAX package draws them with numpy; the two streams
    differ)."""
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    return {"input_ids": torch.randint(0, vocab_size, (batch_size, seq_len), generator=gen,
                                       device=device)}


def params_from_jax(np_params: Mapping[str, Any], config: GPT2Config) -> GPT2Model:
    """A GPT2Model holding the JAX package's GPT-2 params (``wte``, ``wpe``,
    ``lnf_*``, the layer-stacked ``blocks`` dict and the optional
    ``emb_ln_*``, ``lm_head``, ``lm_head_b``), as numpy arrays. Stacked
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
