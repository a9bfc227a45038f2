"""BERT family encoder: masked-LM pretraining.

Counterpart of ``deepspeed_tpu/models/bert.py``: post-LN blocks (x =
LN(x + attn(x)); x = LN(x + mlp(x))) with fused qkv and its biases, word,
learned-position and token-type embeddings followed by the embedding LN,
layer norms in fp32 with ``layer_norm_eps`` (1e-12), exact-erf GELU (or
"gelu_new" / "relu"), and the MLM head: transform (dense, activation, LN),
then the decoder tied to the word embedding plus a free fp32 bias. The loss
is over labels other than ``IGNORE_INDEX`` (-100, the HF convention); with
``max_predictions_per_seq`` the head runs only on each row's first masked
positions (the original BERT's ``gather_indexes``). The JAX model is
functional over a layer-stacked param pytree; here :class:`BertModel` is an
``nn.Module`` with one :class:`BertBlock` per layer. Weights keep the JAX
orientation (``x @ W``), so :func:`params_from_jax` copies them exactly.

Attention is bidirectional: the flash kernels with ``causal=False``, or,
for a batch with an ``attention_mask``, the plain masked path (as in JAX,
where a masked call never reaches the kernel). Each module computes with
its own parameters through ``_gathered(module)`` (``models/common.py``'s
:class:`GatheredModule`); the word embedding gathers for the embedding and
again for the head. There is no KV cache: an encoder does not generate.
``remat`` is off, "full", "dots" or "attn" (``models/common.py``
``remat_call``). ``loss`` takes progressive layer drop's ``pld_theta`` and
the engine's ``generator``: the layers' gates are drawn before the layer
loop, as GPT-2's. ``flash_block`` (the TPU kernel's tile) is accepted and
changes nothing, as in port GPT-2: the CUDA kernels use fixed tiles.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.common import (GatheredModule, assemble, chunked_lm_loss,
                                               gate_layer, init_pieces, layer_norm,
                                               local_causal_attention, meta_weight, pld_gates,
                                               remat_call)
from deepspeed_tpu_torch.utils import env_flag
from deepspeed_tpu_torch.utils.logging import logger

IGNORE_INDEX = -100

_mlm_overflow_warned = False


def _warn_mlm_overflow_once(overflow: bool, maxp: int) -> None:
    global _mlm_overflow_warned
    if overflow and not _mlm_overflow_warned:
        _mlm_overflow_warned = True
        logger.warning(
            f"MLM batch has rows with more than max_predictions_per_seq={maxp} labels; the "
            "gathered head drops the excess from the loss. Cap masking in the data pipeline "
            "(the original BERT builder's max_predictions_per_seq truncation) or raise the "
            "knob.")


def gathered_positions(mask, maxp: int):
    """The positions the gathered MLM head runs on: each row's first
    ``maxp`` positions of ``mask`` (B, T) in index order, then its first
    unmasked ones, and whether each is masked → ((B, maxp) int64, (B, maxp)
    bool). A stable descending sort of the mask: the order of the JAX
    ``top_k``, which ``torch.topk`` does not promise among ties."""
    order = torch.sort(mask.to(torch.int32), dim=1, descending=True, stable=True)
    return order.indices[:, :maxp], order.values[:, :maxp].bool()


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    n_positions: int = 512
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    intermediate_size: Optional[int] = None   # None → 4·d
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    activation: str = "gelu"                  # BERT uses exact-erf gelu
    dtype: Any = torch.bfloat16               # compute type
    # activation checkpointing: False/'none', True/'full' (recompute each
    # block in the backward), 'dots' (keep the matmul outputs) or 'attn'
    # (keep the flash forward's outputs)
    remat: Any = False
    # recompute each loss chunk's fp32 logits in the backward instead of
    # keeping them (models/common.py chunked_lm_loss)
    remat_loss_chunks: bool = True
    use_flash_attention: bool = True
    # the TPU kernel's tile edge; the CUDA kernels use fixed tiles
    flash_block: Optional[int] = None
    # lax.scan unroll factor of the JAX layer loop; the port's layer loop is
    # a Python loop, so it has no effect here
    scan_unroll: int = 1
    # MLM head over each row's first masked positions only (the original
    # BERT's gather_indexes), padded to this count with zero-weight
    # positions; None projects every position. The loss equals the full one
    # only when no row carries more labels than the cap (the original BERT
    # data builder truncates masking at it); DS_DEBUG_MLM=1 warns once when
    # a row does (a host sync per step).
    max_predictions_per_seq: Optional[int] = None

    VALID_REMAT = (False, None, "none", True, "full", "dots", "attn")

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.n_embd
        if self.activation not in ("gelu", "gelu_new", "relu"):
            raise ValueError(f"activation {self.activation!r} unknown")
        if self.remat not in self.VALID_REMAT:
            raise ValueError(f"remat={self.remat!r} not in {self.VALID_REMAT}")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def num_params(self) -> int:
        d, i = self.n_embd, self.intermediate_size
        emb = (self.vocab_size + self.n_positions + self.type_vocab_size) * d + 2 * d
        per_layer = 4 * d * d + 4 * d + 2 * d * i + d + i + 4 * d
        head = d * d + d + 2 * d + self.vocab_size     # transform + LN + decoder bias
        return emb + self.n_layer * per_layer + head

    def flops_per_token(self, seq_len: Optional[int] = None) -> float:
        """6N + 12·l·d·s, the decoders' Megatron accounting. When the MLM
        head runs only on gathered masked positions, the head matmuls the
        model skips are subtracted."""
        s = seq_len or self.n_positions
        f = 6 * self.num_params() + 12 * self.n_layer * self.n_embd * s
        maxp = self.max_predictions_per_seq
        if maxp is not None and maxp < s:
            # per-token head work: vocab decode (d·V, tied wte) + transform (d²)
            head = self.n_embd * self.vocab_size + self.n_embd * self.n_embd
            f -= 6.0 * head * (1.0 - maxp / s)
        return f


PRESETS = {
    "bert-tiny": BertConfig(vocab_size=1024, n_positions=128, n_embd=64,
                            n_layer=2, n_head=4, intermediate_size=128),
    "bert-base": BertConfig(),
    "bert-large": BertConfig(n_embd=1024, n_layer=24, n_head=16),
}

# per-layer weights, in the JAX package's ``blocks`` naming
BLOCK_KEYS = ("qkv_w", "qkv_b", "proj_w", "proj_b", "attn_ln_g", "attn_ln_b",
              "fc_w", "fc_b", "fc2_w", "fc2_b", "mlp_ln_g", "mlp_ln_b")


class BertBlock(nn.Module):
    """One encoder layer's weights (the computation lives on BertModel,
    which gathers them around each use)."""

    def __init__(self, c: BertConfig):
        super().__init__()
        d, i = c.n_embd, c.intermediate_size
        self.qkv_w, self.qkv_b = meta_weight(d, 3 * d), meta_weight(3 * d)
        self.proj_w, self.proj_b = meta_weight(d, d), meta_weight(d)
        self.attn_ln_g, self.attn_ln_b = meta_weight(d), meta_weight(d)
        self.fc_w, self.fc_b = meta_weight(d, i), meta_weight(i)
        self.fc2_w, self.fc2_b = meta_weight(i, d), meta_weight(d)
        self.mlp_ln_g, self.mlp_ln_b = meta_weight(d), meta_weight(d)


class BertModel(GatheredModule):
    def __init__(self, config: BertConfig):
        super().__init__()
        c = self.config = config
        d = c.n_embd
        self.wte = meta_weight(c.vocab_size, d)
        self.wpe = meta_weight(c.n_positions, d)
        self.wtype = meta_weight(c.type_vocab_size, d)
        self.emb_ln_g, self.emb_ln_b = meta_weight(d), meta_weight(d)
        self.blocks = nn.ModuleList(BertBlock(c) for _ in range(c.n_layer))
        # the MLM head (HF cls.predictions): transform dense + LN, decoder
        # bias (the decoder weight is wte)
        self.mlm_w, self.mlm_b = meta_weight(d, d), meta_weight(d)
        self.mlm_ln_g, self.mlm_ln_b = meta_weight(d), meta_weight(d)
        self.decoder_b = meta_weight(c.vocab_size)

    # ---------------------------------------------------------------- params
    def param_chunks(self, generator: torch.Generator, chunk: Optional[int] = None):
        """The random fp32 initial values, as ``(name, start, values)``
        pieces of at most ``chunk`` elements (``models/common.py``
        :func:`init_pieces`), drawn from ``generator`` on its device with the
        JAX package's distribution (every matrix normal 0.02, unit gains,
        zero biases), in the order of the embeddings, each layer's, the
        head's. ``init_params`` assembles the same pieces."""
        c = self.config
        d, i, s = c.n_embd, c.intermediate_size, 0.02
        pieces = init_pieces(generator, chunk)
        yield from pieces("wte", (c.vocab_size, d), s)
        yield from pieces("wpe", (c.n_positions, d), s)
        yield from pieces("wtype", (c.type_vocab_size, d), s)
        yield from pieces("emb_ln_g", (d,), fill=1.0)
        yield from pieces("emb_ln_b", (d,))
        for n in range(c.n_layer):
            for key, shape, scale, fill in (
                    ("qkv_w", (d, 3 * d), s, 0.0), ("qkv_b", (3 * d,), None, 0.0),
                    ("proj_w", (d, d), s, 0.0), ("proj_b", (d,), None, 0.0),
                    ("attn_ln_g", (d,), None, 1.0), ("attn_ln_b", (d,), None, 0.0),
                    ("fc_w", (d, i), s, 0.0), ("fc_b", (i,), None, 0.0),
                    ("fc2_w", (i, d), s, 0.0), ("fc2_b", (d,), None, 0.0),
                    ("mlp_ln_g", (d,), None, 1.0), ("mlp_ln_b", (d,), None, 0.0)):
                yield from pieces(f"blocks.{n}.{key}", shape, scale, fill)
        yield from pieces("mlm_w", (d, d), s)
        yield from pieces("mlm_b", (d,))
        yield from pieces("mlm_ln_g", (d,), fill=1.0)
        yield from pieces("mlm_ln_b", (d,))
        yield from pieces("decoder_b", (c.vocab_size,))

    def init_params(self, generator: torch.Generator) -> "BertModel":
        """Random fp32 weights from ``generator`` on its device: the whole
        tree of ``param_chunks``. Returns self."""
        return assemble(self, self.param_chunks(generator))

    # --------------------------------------------------------------- compute
    def _layer_norm(self, x, g, b):
        return layer_norm(x, g, b, self.config.layer_norm_eps)

    def _act(self, h):
        a = self.config.activation
        if a == "relu":
            return F.relu(h)
        return F.gelu(h, approximate="tanh" if a == "gelu_new" else "none")

    def _embed(self, input_ids, token_type_ids=None):
        """Word + position + token-type embeddings, then the embedding LN."""
        c = self.config
        T = input_ids.shape[1]
        types = torch.zeros_like(input_ids) if token_type_ids is None else token_type_ids
        with self._gathered(self) as top:
            x = top.wte.to(c.dtype)[input_ids] + top.wpe.to(c.dtype)[:T][None] \
                + top.wtype.to(c.dtype)[types]
            return self._layer_norm(x, top.emb_ln_g, top.emb_ln_b)

    def _block(self, x, blk: BertBlock, attention_mask):
        c = self.config
        B, T, D = x.shape
        with self._gathered(blk) as w:
            qkv = x @ w.qkv_w.to(x.dtype) + w.qkv_b.to(x.dtype)
            q, k, v = (t.reshape(B, T, c.n_head, c.head_dim) for t in qkv.split(D, dim=-1))
            attn = local_causal_attention(q, k, v, use_flash=c.use_flash_attention,
                                          causal=False, key_padding_mask=attention_mask)
            attn = attn.reshape(B, T, D) @ w.proj_w.to(x.dtype) + w.proj_b.to(x.dtype)
            x = self._layer_norm(x + attn, w.attn_ln_g, w.attn_ln_b)
            h = x @ w.fc_w.to(x.dtype) + w.fc_b.to(x.dtype)
            h = self._act(h) @ w.fc2_w.to(x.dtype) + w.fc2_b.to(x.dtype)
            return self._layer_norm(x + h, w.mlp_ln_g, w.mlp_ln_b)

    def _trunk(self, input_ids, token_type_ids=None, attention_mask=None, generator=None,
               pld_theta=None):
        """Embeddings and every block; with ``pld_theta`` and ``generator``,
        each block gated by progressive layer drop (``pld_gates``)."""
        c = self.config
        x = self._embed(input_ids, token_type_ids)
        gates = pld_gates(pld_theta, c.n_layer, generator) \
            if pld_theta is not None and generator is not None else None
        for n, blk in enumerate(self.blocks):
            y = remat_call(c.remat, self._block, x, blk, attention_mask)
            x = gate_layer(x, y, None if gates is None else gates[n])
        return x

    def hidden_states(self, input_ids, token_type_ids=None, attention_mask=None):
        """The encoder's output: (B, T) → (B, T, D)."""
        return self._trunk(input_ids, token_type_ids, attention_mask)

    def _mlm_transform(self, top, x):
        """HF cls.predictions.transform: dense + activation + LayerNorm."""
        h = x @ top.mlm_w.to(x.dtype) + top.mlm_b.to(x.dtype)
        return self._layer_norm(self._act(h), top.mlm_ln_g, top.mlm_ln_b)

    def apply(self, input_ids, token_type_ids=None, attention_mask=None):
        """(B, T) → MLM logits (B, T, V) fp32."""
        x = self._trunk(input_ids, token_type_ids, attention_mask)
        with self._gathered(self) as top:
            h = self._mlm_transform(top, x)
            return (h @ top.wte.t().to(h.dtype)).float() + top.decoder_b.float()

    forward = apply

    def _capped(self, labels) -> bool:
        maxp = self.config.max_predictions_per_seq
        return maxp is not None and maxp < labels.shape[1]

    def loss(self, batch, pld_theta=None, generator: Optional[torch.Generator] = None):
        """Masked-LM cross entropy. ``batch``: dict with input_ids and labels
        ((B, T), -100 = not predicted) [+ optional token_type_ids /
        attention_mask (B, T), nonzero = attend]. The vocab projection runs
        through the shared chunked loss, so the (B, T, V) fp32 logits are
        never held at once. With ``max_predictions_per_seq`` the head runs
        on each row's first masked positions in index order
        (:func:`gathered_positions`), padded with zero-weight positions.
        ``pld_theta``: progressive layer drop's keep probability θ, applied
        with the engine's ``generator`` (without one every block runs, as
        JAX without an rng)."""
        ids = batch["input_ids"]
        labels = batch.get("labels", ids)
        x = self._trunk(ids, batch.get("token_type_ids"), batch.get("attention_mask"),
                        generator, pld_theta)
        mask = labels != IGNORE_INDEX
        if self._capped(labels):
            maxp = self.config.max_predictions_per_seq
            if env_flag("DS_DEBUG_MLM"):
                _warn_mlm_overflow_once(bool((mask.sum(dim=1) > maxp).any()), maxp)
            pos, kept = gathered_positions(mask, maxp)
            x = torch.take_along_dim(x, pos[..., None], dim=1)
            labels = torch.take_along_dim(torch.where(mask, labels, 0), pos, dim=1)
            mask = kept
        safe = torch.where(mask, labels, 0)
        with self._gathered(self) as top:
            h = self._mlm_transform(top, x)
            return chunked_lm_loss(h, top.wte.t().to(h.dtype), safe, loss_mask=mask,
                                   bias=top.decoder_b, remat=self.config.remat_loss_chunks)

    def loss_tokens(self, batch):
        """What :meth:`loss` averages over: the count of labels other than
        ``IGNORE_INDEX``, each row's capped at ``max_predictions_per_seq``
        (0-d fp32; the engine weights ranks' losses by it)."""
        labels = batch.get("labels", batch["input_ids"])
        counts = (labels != IGNORE_INDEX).sum(dim=1)
        if self._capped(labels):
            counts = counts.clamp(max=self.config.max_predictions_per_seq)
        return counts.sum().float()


def synthetic_mlm_batch(batch_size: int, seq_len: int, vocab_size: int,
                        mask_frac: float = 0.15, seed: int = 0,
                        max_predictions: Optional[int] = None, device=None):
    """Random MLM batch, the JAX package's draws from a numpy generator
    seeded with ``seed`` (the same ids and labels): ``mask_frac`` of the
    positions predicted (HF -100 convention), their inputs replaced by token
    0 (the [MASK] stand-in); ``max_predictions`` keeps only each row's first
    that many (the original BERT data builder's truncation). Made on the
    host, then moved to ``device``."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab_size, size=(batch_size, seq_len), dtype=np.int32)
    predict = rng.random((batch_size, seq_len)) < mask_frac
    if max_predictions is not None:
        predict &= ~(np.cumsum(predict, axis=1) > max_predictions)
    labels = np.where(predict, ids, IGNORE_INDEX)
    inputs = np.where(predict, 0, ids)
    to = lambda a: torch.from_numpy(a.astype(np.int64)).to(device or "cpu")
    return {"input_ids": to(inputs), "labels": to(labels)}


def params_from_jax(np_params: Mapping[str, Any], config: BertConfig) -> BertModel:
    """A BertModel holding the JAX package's BERT params (the embeddings,
    the MLM head and the layer-stacked ``blocks`` dict), as numpy arrays.
    Stacked (L, ...) block leaves become per-layer weights; the copy is
    exact."""
    t = lambda a: torch.tensor(np.asarray(a))
    sd: Dict[str, torch.Tensor] = {k: t(v) for k, v in np_params.items() if k != "blocks"}
    for key in BLOCK_KEYS:
        stacked = np.asarray(np_params["blocks"][key])
        for n in range(config.n_layer):
            sd[f"blocks.{n}.{key}"] = t(stacked[n])
    model = BertModel(config)
    model.load_state_dict(sd, assign=True)
    return model
