"""HF and diffusers checkpoints into the port's models.

Counterpart of ``deepspeed_tpu/module_inject/hf.py``. Each loader returns
(config, state dict of the port's model): the model is built on the meta
device and filled by ``init_inference(model, params=state_dict)`` or
``model.load_state_dict(state_dict, assign=True)``; ``load_hf_model``
returns the model and its state dict, dispatched on the HF config's
``model_type`` (a diffusers object routes by its config's ``_class_name``).

The language models: GPT-2 (``load_gpt2``) and the GPT-2 variant families
onto ``GPT2Model`` through its config's switches, as the JAX loaders set
them: OPT (``load_opt``: ReLU, learned positions with HF's 2-row offset
dropped), BLOOM (``load_bloom``: ALiBi, the embedding layer norm),
GPT-NeoX / Pythia (``load_gptneox``: partial rotate-half rotary, parallel
residual, the untied ``embed_out``), GPT-Neo (``load_gptneo``: per-layer
global / local windows, the missing 1/sqrt(dh) folded into ``q_w``) and
GPT-J (``load_gptj``: interleaved rotary, parallel residual with its one
``ln_1`` copied into the ``ln2`` slots, zero attention biases, a head
bias). NeoX's and BLOOM's head-interleaved ``query_key_value`` is reordered
to GPT-2's [all q, all k, all v]. A loader takes an object with ``.config``
and ``state_dict()`` (or a bare state dict where the JAX loader allows one,
GPT-2's); the config may be an attribute object or a dict, since the card's
machine has no ``transformers``, and the tensors torch tensors (kept on
their device) or numpy arrays. Weights keep the port's ``x @ W``
orientation, so an ``nn.Linear`` weight is transposed and GPT-2's Conv1D is
not.

The vision part: the CLIP text tower (``load_clip_text``), the UNet
(``load_unet``) and the VAE (``load_vae``), and their flat export
(``export_vision_params``). The UNet's and the VAE's state dicts are the
diffusers ones, key for key (a dtype cast); CLIP's separate q/k/v fuse into
the GPT-2 qkv matrix.

LLaMA (``load_llama``: grouped KV heads, RoPE theta and scaling, the tied
head), BERT (``load_bert``: ``BertForMaskedLM``, its separate q/k/v fused,
the MLM decoder tied to the word embedding) and DistilBERT
(``load_distilbert``: onto ``BertModel`` with a 1-row zero token-type
table). The exporters ``export_gpt2``, ``export_llama`` and
``export_bloom`` are their loaders' inverses: the port's per-layer state
dict (or a model) in, an HF-layout dict of numpy arrays out, which the
loader reads back bit for bit. ``state_dict_to_tree`` nests a flat dotted
state dict. AutoTP comes with inference tensor parallelism, a later slice
of the port.
"""

from __future__ import annotations

import math
import re
import types
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import logger


def hf_state_dict(model_or_sd: Any) -> Dict[str, torch.Tensor]:
    """A torch ``nn.Module`` | state dict | dict of arrays → dict of
    detached tensors, each on the device it lies on (numpy arrays become
    CPU tensors)."""
    sd = model_or_sd
    if hasattr(sd, "state_dict") and callable(sd.state_dict):
        sd = sd.state_dict()
    return {k: (v.detach() if torch.is_tensor(v) else torch.from_numpy(np.asarray(v)))
            for k, v in sd.items()}


def state_dict_to_tree(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Flat dotted-key state dict → nested dict, one level per dot."""
    tree: Dict[str, Any] = {}
    for key, val in sd.items():
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _hf_config(model_or_sd: Any):
    """The object's ``.config`` as an attribute object (a dict config
    becomes one), or None."""
    cfg = getattr(model_or_sd, "config", None)
    return types.SimpleNamespace(**cfg) if isinstance(cfg, Mapping) else cfg


# ------------------------------------------------ shared loader plumbing
def _layer_count(sd: Mapping[str, Any], prefix: str, stem: str) -> int:
    """Number of contiguous '<prefix><stem>.<i>.' layers in the state dict."""
    ids = sorted({int(m.group(1)) for k in sd
                  for m in [re.match(rf"{re.escape(prefix)}{stem}\.(\d+)\.", k)] if m})
    assert ids == list(range(len(ids))), f"non-contiguous layers {ids}"
    return len(ids)


def _stackers(g, layer_tmpl: str):
    """(w, b, t): one layer's weight, bias and transposed weight (torch
    ``nn.Linear`` stores (out, in); the port's matmuls take (in, out)), as
    ``w(i, name)``; the JAX ``_stackers`` stacks the same tensors over a
    leading layer dim."""
    w = lambda i, name: g(layer_tmpl.format(i=i) + name + ".weight")
    b = lambda i, name: g(layer_tmpl.format(i=i) + name + ".bias")
    t = lambda i, name: g(layer_tmpl.format(i=i) + name + ".weight").t()
    return w, b, t


def _deinterleave_qkv(w: torch.Tensor, b: torch.Tensor, n_head: int):
    """BLOOM's and NeoX's fused query_key_value layout ([q_h k_h v_h] rows
    per head) → GPT-2's [all q, all k, all v]: the (3D, D) torch weight in,
    the (D, 3D) port weight and the reordered (3D,) bias out."""
    d3, d = w.shape
    dh = d // n_head
    wt = w.t().reshape(d, n_head, 3, dh).permute(0, 2, 1, 3).reshape(d, d3)
    bt = b.reshape(n_head, 3, dh).permute(1, 0, 2).reshape(d3)
    return wt, bt


def _detect_tied(sd: Mapping[str, torch.Tensor], embed_key: str,
                 head_key: str = "lm_head.weight") -> bool:
    """HF ties the head to the token embedding when the head key is absent
    or equal to it (safetensors materializes shared storage as a copy)."""
    return head_key not in sd or torch.equal(sd[head_key], sd[embed_key])


def _state(out: Dict[str, torch.Tensor], layers, block_keys=None) -> Dict[str, torch.Tensor]:
    """``out`` (the top-level weights) with every layer's block weights as
    ``blocks.<i>.<key>``, contiguous, in ``block_keys`` order (GPT-2's
    ``BLOCK_KEYS`` by default)."""
    if block_keys is None:
        from deepspeed_tpu_torch.models.gpt2 import BLOCK_KEYS as block_keys

    for i, layer in enumerate(layers):
        out.update({f"blocks.{i}.{k}": layer[k].contiguous() for k in block_keys})
    return out


def _export_source(params: Any) -> Dict[str, Any]:
    """A model (its state dict) or a flat state dict of the port's names,
    as the exporters read it."""
    if hasattr(params, "state_dict") and callable(params.state_dict):
        params = params.state_dict()
    return dict(params)


# ------------------------------------------------------------------- GPT-2
def load_gpt2(model_or_sd: Any, dtype=torch.float32) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """HF ``GPT2LMHeadModel`` (or its state dict) → (GPT2Config, state dict)
    for ``models.gpt2.GPT2Model``. HF's Conv1D stores (in, out), the port's
    orientation, so nothing is transposed but an untied ``lm_head``."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config

    sd = hf_state_dict(model_or_sd)
    # "transformer.h.0..." (the LM-head model) or "h.0..." (bare)
    prefix = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    g = lambda name: sd[prefix + name].to(dtype)
    n_layer = _layer_count(sd, prefix, "h")
    wte, wpe = g("wte.weight"), g("wpe.weight")
    vocab, d = wte.shape
    qkv0 = sd[prefix + "h.0.attn.c_attn.weight"]
    assert tuple(qkv0.shape) == (d, 3 * d), f"unexpected c_attn shape {tuple(qkv0.shape)}"
    w, b, _ = _stackers(g, "h.{i}.")
    layers = [{
        "ln1_g": w(i, "ln_1"), "ln1_b": b(i, "ln_1"),
        "qkv_w": w(i, "attn.c_attn"), "qkv_b": b(i, "attn.c_attn"),
        "proj_w": w(i, "attn.c_proj"), "proj_b": b(i, "attn.c_proj"),
        "ln2_g": w(i, "ln_2"), "ln2_b": b(i, "ln_2"),
        "fc_w": w(i, "mlp.c_fc"), "fc_b": b(i, "mlp.c_fc"),
        "fc2_w": w(i, "mlp.c_proj"), "fc2_b": b(i, "mlp.c_proj")} for i in range(n_layer)]
    out = {"wte": wte, "wpe": wpe, "lnf_g": g("ln_f.weight"), "lnf_b": g("ln_f.bias")}
    tied = _detect_tied(sd, prefix + "wte.weight")
    if not tied:
        out["lm_head"] = sd["lm_head.weight"].to(dtype).t().contiguous()
    config = GPT2Config(vocab_size=vocab, n_positions=wpe.shape[0], n_embd=d, n_layer=n_layer,
                        n_head=_infer_gpt2_heads(model_or_sd, d), tie_embeddings=tied,
                        dtype=dtype)
    logger.info(f"load_gpt2: {n_layer} layers, d={d}, vocab={vocab}, heads={config.n_head}")
    return config, _state(out, layers)


def _infer_gpt2_heads(model_or_sd: Any, d: int) -> int:
    cfg = _hf_config(model_or_sd)
    if cfg is not None and getattr(cfg, "n_head", None):
        return int(cfg.n_head)
    # a bare state dict carries no head count: the GPT-2 family's head dim
    # 64 when it divides, else the largest power-of-two divisor
    if d % 64 == 0:
        return d // 64
    h = 1
    while d % (h * 2) == 0:
        h *= 2
    return h


def export_gpt2(params: Any, prefix: str = "transformer.") -> Dict[str, np.ndarray]:
    """Inverse of ``load_gpt2``: the port's GPT-2 state dict (or model) →
    HF ``GPT2LMHeadModel`` layout, numpy arrays (bf16 widened to fp32).
    Conv1D keeps (in, out), so only an untied head transposes; a tied head
    is written as a copy of ``wte``, as safetensors materializes it. A tree
    without ``wpe`` (ALiBi, rotary) has no position table, as in JAX."""
    params = _export_source(params)
    sd: Dict[str, np.ndarray] = {prefix + "wte.weight": _numpy(params["wte"]),
                                 prefix + "ln_f.weight": _numpy(params["lnf_g"]),
                                 prefix + "ln_f.bias": _numpy(params["lnf_b"])}
    if "wpe" in params:
        sd[prefix + "wpe.weight"] = _numpy(params["wpe"])
    names = (("ln_1.weight", "ln1_g"), ("ln_1.bias", "ln1_b"),
             ("attn.c_attn.weight", "qkv_w"), ("attn.c_attn.bias", "qkv_b"),
             ("attn.c_proj.weight", "proj_w"), ("attn.c_proj.bias", "proj_b"),
             ("ln_2.weight", "ln2_g"), ("ln_2.bias", "ln2_b"),
             ("mlp.c_fc.weight", "fc_w"), ("mlp.c_fc.bias", "fc_b"),
             ("mlp.c_proj.weight", "fc2_w"), ("mlp.c_proj.bias", "fc2_b"))
    for i in range(_layer_count(params, "", "blocks")):
        for hf_name, ours in names:
            sd[f"{prefix}h.{i}.{hf_name}"] = _numpy(params[f"blocks.{i}.{ours}"])
    sd["lm_head.weight"] = (_numpy(params["lm_head"]).T if "lm_head" in params
                            else sd[prefix + "wte.weight"])
    return sd


def _n_head(model_or_sd: Any, loader: str, *names: str) -> int:
    """The head count from the HF config's first of ``names`` that is set;
    a bare state dict (no config) raises, as the JAX loaders do."""
    cfg = _hf_config(model_or_sd)
    n = next((int(v) for v in (getattr(cfg, name, 0) for name in names) if v), 0)
    if not n:
        raise ValueError(f"{loader} needs the HF model (its config carries the head count), "
                         "not a bare state dict")
    return n


# ------------------------------------------------------------------- BLOOM
def load_bloom(model_or_sd: Any, dtype=torch.float32) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """HF ``BloomForCausalLM`` → (GPT2Config, state dict) for GPT2Model:
    ALiBi (no position table) and a layer norm after the token embedding;
    the head-interleaved ``query_key_value`` reordered."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config

    n_head = _n_head(model_or_sd, "load_bloom", "n_head", "num_attention_heads")
    sd = hf_state_dict(model_or_sd)
    prefix = next((p for p in ("transformer.", "") if p + "word_embeddings.weight" in sd), "")
    g = lambda name: sd[prefix + name].to(dtype)
    n_layer = _layer_count(sd, prefix, "h")
    wte = g("word_embeddings.weight")
    vocab, d = wte.shape
    w, b, t = _stackers(g, "h.{i}.")
    layers = []
    for i in range(n_layer):
        qkv_w, qkv_b = _deinterleave_qkv(w(i, "self_attention.query_key_value"),
                                         b(i, "self_attention.query_key_value"), n_head)
        layers.append({
            "ln1_g": w(i, "input_layernorm"), "ln1_b": b(i, "input_layernorm"),
            "qkv_w": qkv_w, "qkv_b": qkv_b,
            "proj_w": t(i, "self_attention.dense"), "proj_b": b(i, "self_attention.dense"),
            "ln2_g": w(i, "post_attention_layernorm"), "ln2_b": b(i, "post_attention_layernorm"),
            "fc_w": t(i, "mlp.dense_h_to_4h"), "fc_b": b(i, "mlp.dense_h_to_4h"),
            "fc2_w": t(i, "mlp.dense_4h_to_h"), "fc2_b": b(i, "mlp.dense_4h_to_h")})
    out = {"wte": wte, "emb_ln_g": g("word_embeddings_layernorm.weight"),
           "emb_ln_b": g("word_embeddings_layernorm.bias"),
           "lnf_g": g("ln_f.weight"), "lnf_b": g("ln_f.bias")}
    tied = _detect_tied(sd, prefix + "word_embeddings.weight")
    if not tied:
        out["lm_head"] = sd["lm_head.weight"].to(dtype).t().contiguous()
    # BLOOM has no position table and its config no length: n_positions
    # only sizes buffers, as in the JAX loader
    config = GPT2Config(vocab_size=vocab, n_positions=2048, n_embd=d, n_layer=n_layer,
                        n_head=n_head, activation="gelu_new", alibi=True, embed_layernorm=True,
                        tie_embeddings=tied, dtype=dtype)
    logger.info(f"load_bloom: {n_layer} layers, d={d}, vocab={vocab}, heads={n_head} (ALiBi), "
                f"tied={tied}")
    return config, _state(out, layers)


def export_bloom(params: Any, n_head: int, prefix: str = "transformer.") -> Dict[str, np.ndarray]:
    """Inverse of ``load_bloom``: the port's BLOOM-shaped GPT-2 state dict
    (or model) → HF ``BloomForCausalLM`` layout, numpy arrays. ``n_head``
    is needed to put the fused qkv back in BLOOM's head-interleaved order:
    the weights alone do not carry it."""
    params = _export_source(params)
    n_layer = _layer_count(params, "", "blocks")
    d = int(params["blocks.0.ln1_g"].shape[0])
    dh = d // n_head
    sd: Dict[str, np.ndarray] = {
        prefix + "word_embeddings.weight": _numpy(params["wte"]),
        prefix + "word_embeddings_layernorm.weight": _numpy(params["emb_ln_g"]),
        prefix + "word_embeddings_layernorm.bias": _numpy(params["emb_ln_b"]),
        prefix + "ln_f.weight": _numpy(params["lnf_g"]),
        prefix + "ln_f.bias": _numpy(params["lnf_b"])}
    sd["lm_head.weight"] = (_numpy(params["lm_head"]).T if "lm_head" in params
                            else sd[prefix + "word_embeddings.weight"])
    transposed = (("self_attention.dense", "proj_w"), ("mlp.dense_h_to_4h", "fc_w"),
                  ("mlp.dense_4h_to_h", "fc2_w"))
    biases = (("self_attention.dense", "proj_b"), ("mlp.dense_h_to_4h", "fc_b"),
              ("mlp.dense_4h_to_h", "fc2_b"))
    norms = (("input_layernorm", "ln1_g", "ln1_b"), ("post_attention_layernorm", "ln2_g", "ln2_b"))
    for i in range(n_layer):
        b = lambda key: _numpy(params[f"blocks.{i}.{key}"])
        # [all q, all k, all v] columns → BLOOM's [q_h k_h v_h] rows per head
        w = b("qkv_w").reshape(d, 3, n_head, dh).transpose(0, 2, 1, 3).reshape(d, 3 * d)
        sd[f"{prefix}h.{i}.self_attention.query_key_value.weight"] = w.T
        sd[f"{prefix}h.{i}.self_attention.query_key_value.bias"] = (
            b("qkv_b").reshape(3, n_head, dh).transpose(1, 0, 2).reshape(3 * d))
        for hf_name, ours in transposed:
            sd[f"{prefix}h.{i}.{hf_name}.weight"] = b(ours).T
        for hf_name, ours in biases:
            sd[f"{prefix}h.{i}.{hf_name}.bias"] = b(ours)
        for hf_name, g_key, b_key in norms:
            sd[f"{prefix}h.{i}.{hf_name}.weight"] = b(g_key)
            sd[f"{prefix}h.{i}.{hf_name}.bias"] = b(b_key)
    return sd


# ------------------------------------------------------------------- LLaMA
def load_llama(model_or_sd: Any, dtype=torch.float32) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """HF ``LlamaForCausalLM`` → (LlamaConfig, state dict) for
    ``models.llama.LlamaModel``. The head count, RoPE theta and scaling and
    the norm's eps come from the config: a bare state dict raises (the head
    count is not in the shapes, and a wrong guess changes RoPE), and a
    ``rope_scaling`` type the model lacks raises before any tensor is
    converted. The KV heads are ``k_proj``'s rows over the head dim; the
    head is tied when ``lm_head`` is absent or equals the embedding. Every
    ``nn.Linear`` weight is transposed to the port's (in, out)."""
    from deepspeed_tpu_torch.models.llama import BLOCK_KEYS, LlamaConfig

    n_head = _n_head(model_or_sd, "load_llama", "num_attention_heads")
    cfg = _hf_config(model_or_sd)
    rope_scaling = getattr(cfg, "rope_scaling", None)
    if rope_scaling is not None:
        kind = rope_scaling.get("rope_type", rope_scaling.get("type", "default"))
        if kind not in LlamaConfig.VALID_ROPE_TYPES:
            raise NotImplementedError(f"rope_scaling type {kind!r} not supported (have: "
                                      f"{LlamaConfig.VALID_ROPE_TYPES}): converting would "
                                      "give wrong logits")
        rope_scaling = dict(rope_scaling)
    sd = hf_state_dict(model_or_sd)
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""
    g = lambda name: sd[prefix + name].to(dtype)
    n_layer = _layer_count(sd, prefix, "layers")
    wte = g("embed_tokens.weight")
    vocab, d = wte.shape
    kv_dim = sd[prefix + "layers.0.self_attn.k_proj.weight"].shape[0]
    inter = sd[prefix + "layers.0.mlp.gate_proj.weight"].shape[0]
    head_dim = d // n_head
    assert kv_dim % head_dim == 0, f"kv_dim {kv_dim} vs head_dim {head_dim}"
    w, _, t = _stackers(g, "layers.{i}.")
    layers = [{
        "attn_norm_g": w(i, "input_layernorm"),
        "q_w": t(i, "self_attn.q_proj"), "k_w": t(i, "self_attn.k_proj"),
        "v_w": t(i, "self_attn.v_proj"), "o_w": t(i, "self_attn.o_proj"),
        "mlp_norm_g": w(i, "post_attention_layernorm"),
        "gate_w": t(i, "mlp.gate_proj"), "up_w": t(i, "mlp.up_proj"),
        "down_w": t(i, "mlp.down_proj")} for i in range(n_layer)]
    out = {"wte": wte, "norm_g": g("norm.weight")}
    tied = _detect_tied(sd, prefix + "embed_tokens.weight")
    if not tied:
        out["lm_head"] = sd["lm_head.weight"].to(dtype).t().contiguous()
    config = LlamaConfig(
        vocab_size=vocab, n_embd=d, n_layer=n_layer, n_head=n_head,
        n_kv_head=kv_dim // head_dim, intermediate_size=inter,
        n_positions=int(getattr(cfg, "max_position_embeddings", 2048) or 2048),
        rope_theta=float(getattr(cfg, "rope_theta", 10000.0) or 10000.0),
        rope_scaling=rope_scaling, tie_embeddings=tied,
        rms_norm_eps=float(getattr(cfg, "rms_norm_eps", 1e-5) or 1e-5), dtype=dtype)
    logger.info(f"load_llama: {n_layer} layers, d={d}, vocab={vocab}, heads={n_head}, "
                f"kv_heads={config.n_kv_head}, inter={inter}")
    return config, _state(out, layers, BLOCK_KEYS)


def export_llama(params: Any, prefix: str = "model.") -> Dict[str, np.ndarray]:
    """Inverse of ``load_llama``: the port's llama state dict (or model) →
    HF ``LlamaForCausalLM`` layout, numpy arrays; a tied head is written as
    a copy of the embedding."""
    params = _export_source(params)
    sd: Dict[str, np.ndarray] = {prefix + "embed_tokens.weight": _numpy(params["wte"]),
                                 prefix + "norm.weight": _numpy(params["norm_g"])}
    sd["lm_head.weight"] = (_numpy(params["lm_head"]).T if "lm_head" in params
                            else sd[prefix + "embed_tokens.weight"])
    transposed = (("self_attn.q_proj", "q_w"), ("self_attn.k_proj", "k_w"),
                  ("self_attn.v_proj", "v_w"), ("self_attn.o_proj", "o_w"),
                  ("mlp.gate_proj", "gate_w"), ("mlp.up_proj", "up_w"),
                  ("mlp.down_proj", "down_w"))
    for i in range(_layer_count(params, "", "blocks")):
        p = f"{prefix}layers.{i}."
        sd[p + "input_layernorm.weight"] = _numpy(params[f"blocks.{i}.attn_norm_g"])
        sd[p + "post_attention_layernorm.weight"] = _numpy(params[f"blocks.{i}.mlp_norm_g"])
        for hf_name, ours in transposed:
            sd[f"{p}{hf_name}.weight"] = _numpy(params[f"blocks.{i}.{ours}"]).T
    return sd


# -------------------------------------------------------------------- BERT
def _bert_config(cfg, vocab: int, d: int, n_layer: int, n_head: int, act: str, dtype,
                 intermediate: int, type_vocab: int, eps: float):
    from deepspeed_tpu_torch.models.bert import BertConfig

    return BertConfig(vocab_size=vocab,
                      n_positions=int(getattr(cfg, "max_position_embeddings", 512) or 512),
                      n_embd=d, n_layer=n_layer, n_head=n_head, intermediate_size=intermediate,
                      type_vocab_size=type_vocab, layer_norm_eps=eps, activation=act,
                      dtype=dtype)


def load_bert(model_or_sd: Any, dtype=torch.float32) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """HF ``BertForMaskedLM`` → (BertConfig, state dict) for
    ``models.bert.BertModel``: the separate q/k/v fused into the port's qkv
    ([all q, all k, all v]), the MLM head's transform and decoder bias (its
    decoder weight is the word embedding; an untied one raises). A bare
    ``BertModel`` or a classification head, an activation other than
    relu/gelu/gelu_new and relative position embeddings raise."""
    from deepspeed_tpu_torch.models.bert import BLOCK_KEYS

    n_head = _n_head(model_or_sd, "load_bert", "num_attention_heads")
    cfg = _hf_config(model_or_sd)
    sd = hf_state_dict(model_or_sd)
    if "cls.predictions.transform.dense.weight" not in sd:
        raise NotImplementedError("load_bert converts BertForMaskedLM checkpoints (needs the "
                                  "cls.predictions MLM head); bare BertModel / classification "
                                  "heads are not supported")
    prefix = "bert." if any(k.startswith("bert.") for k in sd) else ""
    g = lambda name: sd[prefix + name].to(dtype)
    top = lambda name: sd[name].to(dtype)
    n_layer = _layer_count(sd, prefix, "encoder.layer")
    wte = g("embeddings.word_embeddings.weight")
    vocab, d = wte.shape
    w, b, t = _stackers(g, "encoder.layer.{i}.")
    a = "attention.self."
    layers = [{
        "qkv_w": torch.cat([t(i, a + n) for n in ("query", "key", "value")], dim=1),
        "qkv_b": torch.cat([b(i, a + n) for n in ("query", "key", "value")]),
        "proj_w": t(i, "attention.output.dense"), "proj_b": b(i, "attention.output.dense"),
        "attn_ln_g": w(i, "attention.output.LayerNorm"),
        "attn_ln_b": b(i, "attention.output.LayerNorm"),
        "fc_w": t(i, "intermediate.dense"), "fc_b": b(i, "intermediate.dense"),
        "fc2_w": t(i, "output.dense"), "fc2_b": b(i, "output.dense"),
        "mlp_ln_g": w(i, "output.LayerNorm"), "mlp_ln_b": b(i, "output.LayerNorm")}
        for i in range(n_layer)]
    out = {"wte": wte, "wpe": g("embeddings.position_embeddings.weight"),
           "wtype": g("embeddings.token_type_embeddings.weight"),
           "emb_ln_g": g("embeddings.LayerNorm.weight"),
           "emb_ln_b": g("embeddings.LayerNorm.bias"),
           "mlm_w": top("cls.predictions.transform.dense.weight").t().contiguous(),
           "mlm_b": top("cls.predictions.transform.dense.bias"),
           "mlm_ln_g": top("cls.predictions.transform.LayerNorm.weight"),
           "mlm_ln_b": top("cls.predictions.transform.LayerNorm.bias"),
           "decoder_b": top("cls.predictions.bias")}
    if not _detect_tied(sd, prefix + "embeddings.word_embeddings.weight",
                        "cls.predictions.decoder.weight"):
        raise NotImplementedError("untied BERT MLM decoder weight not supported")
    act = getattr(cfg, "hidden_act", "gelu") or "gelu"
    if act not in ("relu", "gelu", "gelu_new"):
        raise NotImplementedError(f"BERT hidden_act {act!r} not supported")
    pos_type = getattr(cfg, "position_embedding_type", "absolute") or "absolute"
    if pos_type != "absolute":
        raise NotImplementedError(f"BERT position_embedding_type {pos_type!r} not supported "
                                  "(relative-position attention would silently diverge)")
    config = _bert_config(
        cfg, vocab, d, n_layer, n_head, act, dtype,
        intermediate=int(getattr(cfg, "intermediate_size", 4 * d) or 4 * d),
        type_vocab=int(getattr(cfg, "type_vocab_size", 2) or 2),
        eps=float(getattr(cfg, "layer_norm_eps", 1e-12) or 1e-12))
    logger.info(f"load_bert: {n_layer} layers, d={d}, vocab={vocab}, heads={n_head}")
    return config, _state(out, layers, BLOCK_KEYS)


def load_distilbert(model_or_sd: Any,
                    dtype=torch.float32) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """HF ``DistilBertForMaskedLM`` → (BertConfig, state dict) for
    ``BertModel``: the same post-LN encoder with q/k/v in ``q_lin`` /
    ``k_lin`` / ``v_lin``, no token types (a 1-row zero table: the trunk
    adds row 0), ``hidden_dim`` as the intermediate size, and an MLM head of
    ``vocab_transform``, ``vocab_layer_norm`` and the tied
    ``vocab_projector``. The layer norms take BertConfig's eps, 1e-12, as
    the JAX loader leaves them."""
    from deepspeed_tpu_torch.models.bert import BLOCK_KEYS

    n_head = _n_head(model_or_sd, "load_distilbert", "n_heads")
    cfg = _hf_config(model_or_sd)
    sd = hf_state_dict(model_or_sd)
    if "vocab_transform.weight" not in sd:
        raise NotImplementedError("load_distilbert converts DistilBertForMaskedLM checkpoints "
                                  "(needs the vocab_transform MLM head)")
    prefix = "distilbert." if any(k.startswith("distilbert.") for k in sd) else ""
    g = lambda name: sd[prefix + name].to(dtype)
    top = lambda name: sd[name].to(dtype)
    n_layer = _layer_count(sd, prefix, "transformer.layer")
    wte = g("embeddings.word_embeddings.weight")
    vocab, d = wte.shape
    w, b, t = _stackers(g, "transformer.layer.{i}.")
    a = "attention."
    layers = [{
        "qkv_w": torch.cat([t(i, a + f"{n}_lin") for n in "qkv"], dim=1),
        "qkv_b": torch.cat([b(i, a + f"{n}_lin") for n in "qkv"]),
        "proj_w": t(i, a + "out_lin"), "proj_b": b(i, a + "out_lin"),
        "attn_ln_g": w(i, "sa_layer_norm"), "attn_ln_b": b(i, "sa_layer_norm"),
        "fc_w": t(i, "ffn.lin1"), "fc_b": b(i, "ffn.lin1"),
        "fc2_w": t(i, "ffn.lin2"), "fc2_b": b(i, "ffn.lin2"),
        "mlp_ln_g": w(i, "output_layer_norm"), "mlp_ln_b": b(i, "output_layer_norm")}
        for i in range(n_layer)]
    out = {"wte": wte, "wpe": g("embeddings.position_embeddings.weight"),
           "wtype": torch.zeros(1, d, dtype=dtype, device=wte.device),
           "emb_ln_g": g("embeddings.LayerNorm.weight"),
           "emb_ln_b": g("embeddings.LayerNorm.bias"),
           "mlm_w": top("vocab_transform.weight").t().contiguous(),
           "mlm_b": top("vocab_transform.bias"),
           "mlm_ln_g": top("vocab_layer_norm.weight"),
           "mlm_ln_b": top("vocab_layer_norm.bias"),
           "decoder_b": top("vocab_projector.bias")}
    if not _detect_tied(sd, prefix + "embeddings.word_embeddings.weight",
                        "vocab_projector.weight"):
        raise NotImplementedError("untied DistilBERT vocab_projector not supported")
    act = str(getattr(cfg, "activation", "gelu") or "gelu")
    if act not in ("relu", "gelu", "gelu_new"):
        raise NotImplementedError(f"DistilBERT activation {act!r} not supported")
    config = _bert_config(cfg, vocab, d, n_layer, n_head, act, dtype,
                          intermediate=int(getattr(cfg, "hidden_dim", 4 * d) or 4 * d),
                          type_vocab=1, eps=1e-12)
    logger.info(f"load_distilbert: {n_layer} layers, d={d}, vocab={vocab}, heads={n_head}")
    return config, _state(out, layers, BLOCK_KEYS)


# ------------------------------------------------------------------- GPT-J
def load_gptj(model_or_sd: Any, dtype=torch.float32) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """HF ``GPTJForCausalLM`` → (GPT2Config, state dict) for GPT2Model:
    interleaved rotary on the first ``rotary_dim`` of each head, the
    parallel residual with one shared layer norm (``ln_1`` copied into the
    ``ln2`` slots: both branches normalize the block input with the same
    weights), bias-free attention projections (zero biases) and a bias on
    the untied head."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config

    n_head = _n_head(model_or_sd, "load_gptj", "n_head", "num_attention_heads")
    cfg = _hf_config(model_or_sd)
    sd = hf_state_dict(model_or_sd)
    prefix = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    g = lambda name: sd[prefix + name].to(dtype)
    n_layer = _layer_count(sd, prefix, "h")
    wte = g("wte.weight")
    vocab, d = wte.shape
    rotary_dim = int(getattr(cfg, "rotary_dim", None) or d // n_head)
    w, b, t = _stackers(g, "h.{i}.")
    zeros = torch.zeros(d, dtype=dtype, device=wte.device)
    layers = [{
        "ln1_g": w(i, "ln_1"), "ln1_b": b(i, "ln_1"),
        "qkv_w": torch.cat([t(i, f"attn.{p}_proj") for p in "qkv"], dim=1),
        "qkv_b": torch.zeros(3 * d, dtype=dtype, device=wte.device),
        "proj_w": t(i, "attn.out_proj"), "proj_b": zeros,
        "ln2_g": w(i, "ln_1"), "ln2_b": b(i, "ln_1"),
        "fc_w": t(i, "mlp.fc_in"), "fc_b": b(i, "mlp.fc_in"),
        "fc2_w": t(i, "mlp.fc_out"), "fc2_b": b(i, "mlp.fc_out")} for i in range(n_layer)]
    out = {"wte": wte, "lnf_g": g("ln_f.weight"), "lnf_b": g("ln_f.bias"),
           "lm_head": sd["lm_head.weight"].to(dtype).t().contiguous(),
           "lm_head_b": sd["lm_head.bias"].to(dtype)}
    config = GPT2Config(vocab_size=vocab,
                        n_positions=int(getattr(cfg, "n_positions", 2048) or 2048),
                        n_embd=d, n_layer=n_layer, n_head=n_head, activation="gelu_new",
                        rotary_pct=rotary_dim / (d // n_head), rotary_interleaved=True,
                        parallel_residual=True, tie_embeddings=False, lm_head_bias=True,
                        dtype=dtype)
    logger.info(f"load_gptj: {n_layer} layers, d={d}, vocab={vocab}, heads={n_head}, "
                f"rotary_dim={rotary_dim}")
    return config, _state(out, layers)


# ---------------------------------------------------------------- GPT-NeoX
def load_gptneox(model_or_sd: Any, dtype=torch.float32) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """HF ``GPTNeoXForCausalLM`` (NeoX-20B, the Pythia ladder) →
    (GPT2Config, state dict) for GPT2Model: partial rotate-half rotary on
    ``rotary_pct`` of each head, the parallel residual, the head-interleaved
    ``query_key_value`` reordered, the head the untied ``embed_out``."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config

    n_head = _n_head(model_or_sd, "load_gptneox", "num_attention_heads")
    cfg = _hf_config(model_or_sd)
    act = getattr(cfg, "hidden_act", "gelu") or "gelu"
    if act not in ("relu", "gelu", "gelu_new"):
        raise NotImplementedError(f"GPT-NeoX hidden_act {act!r} not supported")
    sd = hf_state_dict(model_or_sd)
    prefix = next((p for p in ("gpt_neox.", "") if p + "embed_in.weight" in sd), "")
    g = lambda name: sd[prefix + name].to(dtype)
    n_layer = _layer_count(sd, prefix, "layers")
    wte = g("embed_in.weight")
    vocab, d = wte.shape
    w, b, t = _stackers(g, "layers.{i}.")
    layers = []
    for i in range(n_layer):
        qkv_w, qkv_b = _deinterleave_qkv(w(i, "attention.query_key_value"),
                                         b(i, "attention.query_key_value"), n_head)
        layers.append({
            "ln1_g": w(i, "input_layernorm"), "ln1_b": b(i, "input_layernorm"),
            "qkv_w": qkv_w, "qkv_b": qkv_b,
            "proj_w": t(i, "attention.dense"), "proj_b": b(i, "attention.dense"),
            "ln2_g": w(i, "post_attention_layernorm"), "ln2_b": b(i, "post_attention_layernorm"),
            "fc_w": t(i, "mlp.dense_h_to_4h"), "fc_b": b(i, "mlp.dense_h_to_4h"),
            "fc2_w": t(i, "mlp.dense_4h_to_h"), "fc2_b": b(i, "mlp.dense_4h_to_h")})
    out = {"wte": wte, "lnf_g": g("final_layer_norm.weight"),
           "lnf_b": g("final_layer_norm.bias")}
    tied = _detect_tied(sd, prefix + "embed_in.weight", "embed_out.weight")
    if not tied:
        out["lm_head"] = sd["embed_out.weight"].to(dtype).t().contiguous()
    config = GPT2Config(
        vocab_size=vocab,
        n_positions=int(getattr(cfg, "max_position_embeddings", 2048) or 2048),
        n_embd=d, n_layer=n_layer, n_head=n_head, activation=act,
        rotary_pct=float(getattr(cfg, "rotary_pct", 0.25) or 0.25),
        # transformers renames GPTNeoXConfig's rotary_emb_base to rope_theta:
        # the new name first, so that a base other than the default survives
        rotary_theta=float(getattr(cfg, "rope_theta", None)
                           or getattr(cfg, "rotary_emb_base", 10000.0) or 10000.0),
        parallel_residual=bool(getattr(cfg, "use_parallel_residual", True)),
        tie_embeddings=tied, dtype=dtype)
    logger.info(f"load_gptneox: {n_layer} layers, d={d}, vocab={vocab}, heads={n_head}, "
                f"rotary_pct={config.rotary_pct}, "
                f"parallel_residual={config.parallel_residual}")
    return config, _state(out, layers)


# --------------------------------------------------------------------- OPT
def load_opt(model_or_sd: Any, dtype=torch.float32) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """HF ``OPTForCausalLM`` → (GPT2Config, state dict) for GPT2Model: the
    separate q/k/v fused into GPT-2's qkv, the position table without its
    2 leading rows (HF's ``OPTLearnedPositionalEmbedding`` reads row i + 2
    for position i), the ReLU MLP. OPT-350m's post-LN and a
    ``word_embed_proj_dim`` other than the hidden size raise."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config

    n_head = _n_head(model_or_sd, "load_opt", "num_attention_heads")
    cfg = _hf_config(model_or_sd)
    if getattr(cfg, "do_layer_norm_before", True) is False:
        raise NotImplementedError("OPT-350m-style post-LN (do_layer_norm_before=False) "
                                  "not supported")
    act = getattr(cfg, "activation_function", "relu") or "relu"
    if act not in ("relu", "gelu", "gelu_new"):
        raise NotImplementedError(f"OPT activation_function {act!r} not supported "
                                  "(relu, gelu, gelu_new)")
    if getattr(cfg, "word_embed_proj_dim", None) not in (None, getattr(cfg, "hidden_size", None)):
        raise NotImplementedError("OPT word_embed_proj_dim != hidden_size (project_in/out) "
                                  "not supported")
    sd = hf_state_dict(model_or_sd)
    prefix = next((p for p in ("model.decoder.", "decoder.", "")
                   if p + "embed_tokens.weight" in sd), "")
    g = lambda name: sd[prefix + name].to(dtype)
    n_layer = _layer_count(sd, prefix, "layers")
    wte = g("embed_tokens.weight")
    vocab, d = wte.shape
    wpe = g("embed_positions.weight")[2:]
    w, b, t = _stackers(g, "layers.{i}.")
    layers = [{
        "ln1_g": w(i, "self_attn_layer_norm"), "ln1_b": b(i, "self_attn_layer_norm"),
        "qkv_w": torch.cat([t(i, f"self_attn.{p}_proj") for p in "qkv"], dim=1),
        "qkv_b": torch.cat([b(i, f"self_attn.{p}_proj") for p in "qkv"]),
        "proj_w": t(i, "self_attn.out_proj"), "proj_b": b(i, "self_attn.out_proj"),
        "ln2_g": w(i, "final_layer_norm"), "ln2_b": b(i, "final_layer_norm"),
        "fc_w": t(i, "fc1"), "fc_b": b(i, "fc1"),
        "fc2_w": t(i, "fc2"), "fc2_b": b(i, "fc2")} for i in range(n_layer)]
    out = {"wte": wte, "wpe": wpe.contiguous(), "lnf_g": g("final_layer_norm.weight"),
           "lnf_b": g("final_layer_norm.bias")}
    tied = _detect_tied(sd, prefix + "embed_tokens.weight")
    if not tied:
        out["lm_head"] = sd["lm_head.weight"].to(dtype).t().contiguous()
    config = GPT2Config(vocab_size=vocab, n_positions=wpe.shape[0], n_embd=d, n_layer=n_layer,
                        n_head=n_head, activation=act, tie_embeddings=tied, dtype=dtype)
    logger.info(f"load_opt: {n_layer} layers, d={d}, vocab={vocab}, heads={n_head}, act={act}, "
                f"tied={tied}")
    return config, _state(out, layers)


# ---------------------------------------------------------------- GPT-Neo
def load_gptneo(model_or_sd: Any, dtype=torch.float32) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """HF ``GPTNeoForCausalLM`` (gpt-neo-125M/1.3B/2.7B) → (GPT2Config,
    state dict) for GPT2Model: alternating global / local sliding-window
    attention per ``attention_layers``; no 1/sqrt(dh) scale in GPT-Neo's
    attention, so ``q_w`` is multiplied by sqrt(dh) here (exact: q has no
    bias) and the kernels' scale restores it; bias-free q/k/v, learned
    positions, the tied head."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config

    cfg = _hf_config(model_or_sd)
    n_head = int(getattr(cfg, "num_heads", 0) or 0)
    attn_layers = getattr(cfg, "attention_layers", None)
    if not n_head or attn_layers is None:
        raise ValueError("load_gptneo needs the HF model (its config carries num_heads and "
                         "attention_layers), not a bare state dict")
    sd = hf_state_dict(model_or_sd)
    prefix = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    g = lambda name: sd[prefix + name].to(dtype)
    n_layer = _layer_count(sd, prefix, "h")
    wte = g("wte.weight")
    vocab, d = wte.shape
    root_dh = torch.tensor(math.sqrt(d // n_head), dtype=dtype)
    w, b, t = _stackers(g, "h.{i}.")
    a = "attn.attention."
    layers = [{
        "ln1_g": w(i, "ln_1"), "ln1_b": b(i, "ln_1"),
        "qkv_w": torch.cat([t(i, a + "q_proj") * root_dh.to(wte.device), t(i, a + "k_proj"),
                            t(i, a + "v_proj")], dim=1),
        "qkv_b": torch.zeros(3 * d, dtype=dtype, device=wte.device),
        "proj_w": t(i, a + "out_proj"), "proj_b": b(i, a + "out_proj"),
        "ln2_g": w(i, "ln_2"), "ln2_b": b(i, "ln_2"),
        "fc_w": t(i, "mlp.c_fc"), "fc_b": b(i, "mlp.c_fc"),
        "fc2_w": t(i, "mlp.c_proj"), "fc2_b": b(i, "mlp.c_proj")} for i in range(n_layer)]
    if not _detect_tied(sd, prefix + "wte.weight"):
        raise NotImplementedError("untied GPT-Neo lm_head not supported")
    out = {"wte": wte, "wpe": g("wpe.weight"), "lnf_g": g("ln_f.weight"),
           "lnf_b": g("ln_f.bias")}
    config = GPT2Config(
        vocab_size=vocab,
        n_positions=int(getattr(cfg, "max_position_embeddings", 2048) or 2048),
        n_embd=d, n_layer=n_layer, n_head=n_head,
        activation=str(getattr(cfg, "activation_function", "gelu_new") or "gelu_new"),
        attention_layers=tuple(attn_layers),
        window_size=int(getattr(cfg, "window_size", 256) or 256), dtype=dtype)
    n_local = sum(1 for x in config.attention_layers if x == "local")
    logger.info(f"load_gptneo: {n_layer} layers ({n_local} local, window="
                f"{config.window_size}), d={d}, vocab={vocab}, heads={n_head}")
    return config, _state(out, layers)


# ------------------------------------------------------------------- CLIP
def load_clip_text(model_or_sd: Any, dtype=torch.float32) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """HF ``CLIPTextModel`` (or the text tower of a ``CLIPModel``) →
    (GPT2Config, state dict) for ``models.clip.CLIPTextEncoder``.

    CLIP's text transformer is a pre-LN causal trunk with quick-GELU: the
    separate q/k/v fuse into the GPT-2 qkv matrix and ``final_layer_norm``
    lands in the ``lnf`` slots. The port's GPT-2 MLP is 4 x ``n_embd`` wide
    (CLIP ViT-L/14's text tower is); another width raises. The config's
    ``eos_token_id`` rides on the returned config, for ``pooled``."""
    from deepspeed_tpu_torch.models.gpt2 import BLOCK_KEYS, GPT2Config

    cfg = getattr(model_or_sd, "config", None)
    if cfg is not None and hasattr(cfg, "text_config"):   # a whole CLIPModel
        cfg = cfg.text_config
    n_head = int(getattr(cfg, "num_attention_heads", 0) or 0)
    if not n_head:
        raise ValueError("load_clip_text needs the HF model (its config carries "
                         "num_attention_heads), not a bare state dict")

    sd = hf_state_dict(model_or_sd)
    prefix = "text_model." if any(k.startswith("text_model.") for k in sd) else ""
    g = lambda name: sd[prefix + name].to(dtype)
    n_layer = _layer_count(sd, prefix, "encoder.layers")
    wte = g("embeddings.token_embedding.weight")
    vocab, d = wte.shape
    if g("encoder.layers.0.mlp.fc1.weight").shape[0] != 4 * d:
        raise NotImplementedError("a CLIP MLP wider or narrower than 4 x hidden_size: "
                                  "later slice of the port")

    out = {"wte": wte, "wpe": g("embeddings.position_embedding.weight"),
           "lnf_g": g("final_layer_norm.weight"), "lnf_b": g("final_layer_norm.bias")}
    for i in range(n_layer):
        p = f"encoder.layers.{i}."
        a = p + "self_attn."
        layer = {
            "ln1_g": g(p + "layer_norm1.weight"), "ln1_b": g(p + "layer_norm1.bias"),
            "qkv_w": torch.cat([g(a + f"{n}_proj.weight").t() for n in "qkv"], dim=1),
            "qkv_b": torch.cat([g(a + f"{n}_proj.bias") for n in "qkv"]),
            "proj_w": g(a + "out_proj.weight").t(), "proj_b": g(a + "out_proj.bias"),
            "ln2_g": g(p + "layer_norm2.weight"), "ln2_b": g(p + "layer_norm2.bias"),
            "fc_w": g(p + "mlp.fc1.weight").t(), "fc_b": g(p + "mlp.fc1.bias"),
            "fc2_w": g(p + "mlp.fc2.weight").t(), "fc2_b": g(p + "mlp.fc2.bias")}
        out.update({f"blocks.{i}.{k}": layer[k].contiguous() for k in BLOCK_KEYS})

    act = str(getattr(cfg, "hidden_act", "quick_gelu") or "quick_gelu")
    if act not in ("gelu", "quick_gelu"):
        raise NotImplementedError(f"CLIP hidden_act {act!r} not supported")
    config = GPT2Config(vocab_size=vocab,
                        n_positions=int(getattr(cfg, "max_position_embeddings", 77) or 77),
                        n_embd=d, n_layer=n_layer, n_head=n_head, activation=act, dtype=dtype)
    eos = getattr(cfg, "eos_token_id", None)
    config._clip_eos_token_id = int(eos) if eos is not None else None
    logger.info(f"load_clip_text: {n_layer} layers, d={d}, vocab={vocab}, heads={n_head}")
    return config, out


def _clip_model(config):
    from deepspeed_tpu_torch.models.clip import CLIPTextEncoder

    return CLIPTextEncoder(config, eos_token_id=getattr(config, "_clip_eos_token_id", None))


# -------------------------------------------------------- diffusers (vision)
def _vision_sd(model_or_sd: Any, dtype) -> Dict[str, torch.Tensor]:
    return {k: v.to(dtype) for k, v in hf_state_dict(model_or_sd).items()}


def load_unet(model_or_sd: Any, dtype=torch.float32, config=None):
    """diffusers ``UNet2DConditionModel`` (or its state dict with an explicit
    ``config``) → (UNetConfig, state dict) for
    ``models.diffusion.UNet2DConditionModel``: the diffusers keys, cast."""
    from deepspeed_tpu_torch.models.diffusion import UNetConfig

    sd = _vision_sd(model_or_sd, dtype)
    if config is None:
        hf = getattr(model_or_sd, "config", None)
        if hf is None:
            raise ValueError("load_unet needs a diffusers model (its config carries "
                             "the block layout) or an explicit UNetConfig")
        # diffusers' attention_head_dim is the head COUNT (per down block in
        # SD-2.x); UNetConfig keeps its name and meaning
        hd = getattr(hf, "attention_head_dim", 8)
        hd = tuple(hd) if isinstance(hd, (list, tuple)) else int(hd)
        config = UNetConfig(
            in_channels=int(hf.in_channels), out_channels=int(hf.out_channels),
            block_out_channels=tuple(hf.block_out_channels),
            layers_per_block=int(hf.layers_per_block),
            down_block_types=tuple(hf.down_block_types),
            up_block_types=tuple(hf.up_block_types),
            cross_attention_dim=int(hf.cross_attention_dim), attention_head_dim=hd,
            norm_num_groups=int(getattr(hf, "norm_num_groups", 32) or 32),
            use_linear_projection=bool(getattr(hf, "use_linear_projection", False)),
            dtype=dtype)
    logger.info(f"load_unet: blocks={config.block_out_channels}, "
                f"ctx={config.cross_attention_dim}")
    return config, sd


def load_vae(model_or_sd: Any, dtype=torch.float32, config=None):
    """diffusers ``AutoencoderKL`` (or its state dict with an explicit
    ``config``) → (VAEConfig, state dict) for ``models.diffusion.AutoencoderKL``."""
    from deepspeed_tpu_torch.models.diffusion import VAEConfig

    sd = _vision_sd(model_or_sd, dtype)
    if config is None:
        hf = getattr(model_or_sd, "config", None)
        if hf is None:
            raise ValueError("load_vae needs a diffusers model or an explicit VAEConfig")
        config = VAEConfig(
            in_channels=int(hf.in_channels), out_channels=int(hf.out_channels),
            latent_channels=int(hf.latent_channels),
            block_out_channels=tuple(hf.block_out_channels),
            layers_per_block=int(hf.layers_per_block),
            norm_num_groups=int(getattr(hf, "norm_num_groups", 32) or 32),
            scaling_factor=float(getattr(hf, "scaling_factor", 0.18215) or 0.18215),
            dtype=dtype)
    logger.info(f"load_vae: blocks={config.block_out_channels}, "
                f"latent={config.latent_channels}")
    return config, sd


def export_vision_params(params: Any) -> Dict[str, np.ndarray]:
    """A model (its state dict), a nested diffusers-layout tree (the JAX
    package's) or a flat dict → flat dotted dict of numpy arrays, as
    diffusers names them."""
    from deepspeed_tpu_torch.models.diffusion import flatten_tree

    if hasattr(params, "state_dict") and callable(params.state_dict):
        params = params.state_dict()
    return {k: _numpy(v) for k, v in flatten_tree(params).items()}


def _numpy(v) -> np.ndarray:
    """A tensor (bf16 widened to fp32: numpy has no bf16) or array as numpy."""
    if not torch.is_tensor(v):
        return np.asarray(v)
    v = v.detach().cpu()
    return (v.float() if v.dtype == torch.bfloat16 else v).numpy()


def _vision_factory(architecture: str):
    def make(config):
        from deepspeed_tpu_torch.models.diffusion import AutoencoderKL, UNet2DConditionModel

        return (UNet2DConditionModel(config) if architecture == "unet"
                else AutoencoderKL(config))
    return make


def _gpt2_model(config):
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model

    return GPT2Model(config)


def _llama_model(config):
    from deepspeed_tpu_torch.models.llama import LlamaModel

    return LlamaModel(config)


def _bert_model(config):
    from deepspeed_tpu_torch.models.bert import BertModel

    return BertModel(config)


# architecture → (state-dict loader, model factory)
_LOADERS = {"gpt2": (load_gpt2, _gpt2_model),
            "llama": (load_llama, _llama_model),
            "opt": (load_opt, _gpt2_model),
            "bloom": (load_bloom, _gpt2_model),
            "gpt_neox": (load_gptneox, _gpt2_model),
            "gpt_neo": (load_gptneo, _gpt2_model),
            "gptj": (load_gptj, _gpt2_model),
            "bert": (load_bert, _bert_model),
            "distilbert": (load_distilbert, _bert_model),
            "clip": (load_clip_text, _clip_model),
            "clip_text_model": (load_clip_text, _clip_model),
            "unet": (load_unet, _vision_factory("unet")),
            "vae": (load_vae, _vision_factory("vae"))}


def load_hf_model(model_or_sd: Any, architecture: Optional[str] = None, dtype=torch.float32):
    """HF or diffusers model / state dict → (the port's model, its state
    dict), ready for ``init_inference(model=..., params=...)``.

    ``architecture`` defaults to the HF config's ``model_type`` (the config
    an attribute object or a dict), or, for a diffusers config, its
    ``_class_name`` (``UNet2DConditionModel`` → unet, ``AutoencoderKL`` →
    vae)."""
    if architecture is None:
        cfg = _hf_config(model_or_sd)
        architecture = getattr(cfg, "model_type", None)
        if not architecture and cfg is not None:
            architecture = {"UNet2DConditionModel": "unet",
                            "AutoencoderKL": "vae"}.get(getattr(cfg, "_class_name", None))
    if architecture not in _LOADERS:
        raise NotImplementedError(
            f"loading architecture {architecture!r}: the port loads {sorted(_LOADERS)}")
    loader, model_factory = _LOADERS[architecture]
    config, params = loader(model_or_sd, dtype=dtype)
    return model_factory(config), params
