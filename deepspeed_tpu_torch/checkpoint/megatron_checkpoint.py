"""Megatron-DeepSpeed checkpoints into the port's GPT-2 and MoE GPT-2.

Counterpart of ``deepspeed_tpu/checkpoint/megatron_checkpoint.py`` (after
the reference's ``deepspeed/checkpoint/deepspeed_checkpoint.py``): read the
layer-file grid, merge the tp shards (``meg_2d.py``'s rules), reorder
Megatron's per-head-interleaved qkv and transpose every ``nn.Linear`` weight
to the port's (in, out). The result is the state dict of
``models.gpt2.GPT2Model`` (or ``models.gpt2_moe.MoEGPT2``), per layer, as
``init_inference(model, params=...)`` takes it.

The files (Megatron-DeepSpeed's layout), read with ``torch.load(...,
weights_only=True)`` onto the host:

    layer_00-model_00-model_states.pt     word and position embeddings (per tp)
    layer_NN-model_TT-model_states.pt     transformer layer NN, tp shard TT
    layer_LAST-model_TT-model_states.pt   the final layer norm

The embedding and final-norm files are recognized by their content (the
``word_embeddings`` and final-norm keys), not by their index.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.checkpoint.meg_2d import merge_tp_shards
from deepspeed_tpu_torch.utils.logging import logger

_LAYER_RE = re.compile(r"layer_(\d+)-model_(\d+)-model_states\.pt$")
_EXPERT_RE = re.compile(r"layer_(\d+)_expert_(\d+)_mp_rank_(\d+)_model_states\.pt$")


def _is_embedding(sd: Dict) -> bool:
    return any("word_embeddings" in k for k in sd)


def _is_final_norm(sd: Dict) -> bool:
    return not _is_embedding(sd) and all(("final_layernorm" in k) or k in ("weight", "bias")
                                         for k in sd)


def _load(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


class DeepSpeedCheckpoint:
    """Index and merge a Megatron-DeepSpeed layer-file checkpoint directory."""

    def __init__(self, ckpt_dir: str, tp_degree: Optional[int] = None,
                 pp_degree: Optional[int] = None):
        self.dir = ckpt_dir
        files = sorted(f for f in os.listdir(ckpt_dir) if _LAYER_RE.search(f))
        if not files:
            raise FileNotFoundError(f"no layer_XX-model_YY-model_states.pt files in {ckpt_dir}")
        # the real file names by (layer, tp): the digits' padding varies
        # across Megatron-DeepSpeed forks (layer_01, layer_001)
        self._files = {}
        for f in files:
            m = _LAYER_RE.search(f)
            self._files[(int(m.group(1)), int(m.group(2)))] = f
        self.layer_ids = sorted({layer for layer, _ in self._files})
        found_tp = len({t for _, t in self._files})
        self.tp_degree = found_tp if tp_degree is None else tp_degree
        if self.tp_degree != found_tp:
            raise ValueError(f"tp_degree={tp_degree} but files show {found_tp}")
        first = self._load(self.layer_ids[0], 0)
        last = self._load(self.layer_ids[-1], 0)
        self.embedding_layer_id = self.layer_ids[0] if _is_embedding(first) else None
        self.final_norm_layer_id = self.layer_ids[-1] if _is_final_norm(last) else None
        self.transformer_layer_ids = [
            layer for layer in self.layer_ids
            if layer not in (self.embedding_layer_id, self.final_norm_layer_id)]
        self.pp_degree = pp_degree or 1
        logger.info(f"DeepSpeedCheckpoint: {len(self.transformer_layer_ids)} transformer "
                    f"layers, tp={self.tp_degree} in {ckpt_dir}")

    def _load(self, layer: int, tp: int) -> Dict[str, torch.Tensor]:
        return _load(os.path.join(self.dir, self._files[(layer, tp)]))

    def _merged(self, layer: int) -> Dict[str, torch.Tensor]:
        return merge_tp_shards([self._load(layer, t) for t in range(self.tp_degree)])

    def get_embedding_state(self) -> Dict[str, torch.Tensor]:
        if self.embedding_layer_id is None:
            raise KeyError("checkpoint has no embedding layer file")
        return self._merged(self.embedding_layer_id)

    def get_final_norm_state(self) -> Dict[str, torch.Tensor]:
        if self.final_norm_layer_id is None:
            raise KeyError("checkpoint has no final-norm layer file")
        return self._merged(self.final_norm_layer_id)

    def get_transformer_state(self, layer_index: int) -> Dict[str, torch.Tensor]:
        """One transformer layer, merged over tp. Megatron's fused qkv is
        stored per shard as (heads of the shard, 3, dh, h) rows, so a dim-0
        concatenation is already the global (heads, 3, dh, h) order; the
        (3, heads) reorder comes at conversion."""
        return self._merged(self.transformer_layer_ids[layer_index])

    def num_layers(self) -> int:
        return len(self.transformer_layer_ids)


def _qkv_meg_to_ours(w: torch.Tensor, n_head: int) -> torch.Tensor:
    """Megatron's fused qkv weight (3h, h), rows in (head, 3, dh) order →
    the port's (h, 3h), columns [q of all heads | k | v]."""
    h3, h = w.shape
    dh = h3 // (3 * n_head)
    return w.reshape(n_head, 3, dh, h).permute(1, 0, 2, 3).reshape(h3, h).t().contiguous()


def _qkv_bias_meg_to_ours(b: torch.Tensor, n_head: int) -> torch.Tensor:
    dh = b.shape[0] // (3 * n_head)
    return b.reshape(n_head, 3, dh).permute(1, 0, 2).reshape(-1).contiguous()


def _g(sd: Dict[str, torch.Tensor], suffix: str, default_shape=None) -> torch.Tensor:
    """The entry of a Megatron state dict whose name ends with ``suffix``;
    with ``default_shape``, zeros when there is none (a MoE layer's file has
    no dense-MLP keys, and its block's dense MLP is never used)."""
    for k in sd:
        if k == suffix or k.endswith(suffix):
            return sd[k]
    if default_shape is not None:
        return torch.zeros(default_shape)
    raise KeyError(f"{suffix} not found (keys: {sorted(sd)[:6]}...)")


def _gpt_trunk(ck: DeepSpeedCheckpoint, n_head: int, dtype, mlp_optional: bool = False):
    """The Megatron → GPT-2 conversion the dense and MoE loaders share: →
    (GPT2Config, state dict, the merged layer dicts). ``mlp_optional``
    fills the dense MLP of the layers that have none (MoE layers) with
    zeros."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config

    emb = ck.get_embedding_state()
    wte = emb[next(k for k in emb if "word_embeddings" in k)]
    pos_keys = [k for k in emb if "position_embeddings" in k]
    wpe = emb[pos_keys[0]] if pos_keys else None
    layers = [ck.get_transformer_state(i) for i in range(ck.num_layers())]
    fin = ck.get_final_norm_state()
    d = wte.shape[1]
    qkv0 = _g(layers[0], "self_attention.query_key_value.weight")
    # the layer files carry no model arguments: the caller passes n_head,
    # as the reference's conversion scripts take it from Megatron's args
    if d % n_head:
        raise ValueError(f"n_head {n_head} does not divide hidden {d}")
    if 3 * d != qkv0.shape[0]:
        raise ValueError(f"qkv rows {qkv0.shape[0]} != 3*hidden {3 * d}")
    hid = next((_g(sd, "mlp.dense_h_to_4h.weight").shape[0] for sd in layers
                if any("dense_h_to_4h.weight" in k for k in sd)), 4 * d)
    fc_dflt = ((hid, d), (hid,), (d, hid), (d,)) if mlp_optional else (None,) * 4
    A = lambda x: x.to(dtype).contiguous()
    out = {"wte": A(wte),
           "lnf_g": A(_g(fin, "weight") if "weight" in fin else _g(fin, "final_layernorm.weight")),
           "lnf_b": A(_g(fin, "bias") if "bias" in fin else _g(fin, "final_layernorm.bias"))}
    if wpe is not None:
        out["wpe"] = A(wpe)
    for i, s in enumerate(layers):
        block = {
            "ln1_g": _g(s, "input_layernorm.weight"), "ln1_b": _g(s, "input_layernorm.bias"),
            "qkv_w": _qkv_meg_to_ours(_g(s, "self_attention.query_key_value.weight"), n_head),
            "qkv_b": _qkv_bias_meg_to_ours(_g(s, "self_attention.query_key_value.bias"),
                                           n_head),
            "proj_w": _g(s, "self_attention.dense.weight").t(),
            "proj_b": _g(s, "self_attention.dense.bias"),
            "ln2_g": _g(s, "post_attention_layernorm.weight"),
            "ln2_b": _g(s, "post_attention_layernorm.bias"),
            "fc_w": _g(s, "mlp.dense_h_to_4h.weight", fc_dflt[0]).t(),
            "fc_b": _g(s, "mlp.dense_h_to_4h.bias", fc_dflt[1]),
            "fc2_w": _g(s, "mlp.dense_4h_to_h.weight", fc_dflt[2]).t(),
            "fc2_b": _g(s, "mlp.dense_4h_to_h.bias", fc_dflt[3])}
        out.update({f"blocks.{i}.{k}": A(v) for k, v in block.items()})
    config = GPT2Config(vocab_size=int(wte.shape[0]),
                        n_positions=int(wpe.shape[0]) if wpe is not None else 2048,
                        n_embd=int(d), n_layer=len(layers), n_head=int(n_head),
                        tie_embeddings=True, dtype=dtype)
    return config, out, layers


def load_megatron_gpt(ckpt_dir: str, n_head: int, dtype=torch.float32,
                      tp_degree: Optional[int] = None) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """A Megatron-DeepSpeed GPT checkpoint directory → (GPT2Config, the
    GPT2Model state dict in ``dtype``, on the host). The config's ``dtype``
    is ``dtype``."""
    ck = DeepSpeedCheckpoint(ckpt_dir, tp_degree=tp_degree)
    config, sd, layers = _gpt_trunk(ck, n_head, dtype)
    logger.info(f"load_megatron_gpt: {len(layers)} layers, d={config.n_embd}, "
                f"vocab={config.vocab_size}, heads={n_head} (from tp={ck.tp_degree} files)")
    return config, sd


def load_megatron_moe(ckpt_dir: str, n_head: int, dtype=torch.float32,
                      tp_degree: Optional[int] = None
                      ) -> Tuple[Any, Dict[str, torch.Tensor], int]:
    """A Megatron-DeepSpeed MoE GPT checkpoint → (GPT2Config, the MoEGPT2
    state dict of every expert, the expert count).

    The dense trunk is in the layer files; a layer is MoE when its file
    holds a ``...deepspeed_moe.gate.wg.weight`` (and no dense-MLP keys).
    The experts are in ``layer_{L}_expert_{E}_mp_rank_{MM}_model_states.pt``
    files (L the index among the MoE layers, the reference's
    ``_get_expert_ckpt_name``), with keys ending in
    ``deepspeed_experts.{E}.dense_h_to_4h`` / ``dense_4h_to_h`` ``.weight``
    and ``.bias``; their mp shards merge by Megatron's MLP rules. The MoE
    layers must be MoEGPT2's (every other block: 1, 3, 5, ...), and the
    gate's expert count the files'; else it raises."""
    ck = DeepSpeedCheckpoint(ckpt_dir, tp_degree=tp_degree)
    config, sd, layers = _gpt_trunk(ck, n_head, dtype, mlp_optional=True)
    moe_ids = [i for i, s in enumerate(layers) if any("deepspeed_moe.gate" in k for k in s)]
    if moe_ids != list(range(1, len(layers), 2)):
        raise ValueError(f"MoE layers at {moe_ids}: MoEGPT2 serves the Switch interleave "
                         f"(every other block: {list(range(1, len(layers), 2))}); other "
                         "placements need a model-side layout first")
    exp_files: Dict[Tuple[int, int, int], str] = {}
    for f in os.listdir(ckpt_dir):
        m = _EXPERT_RE.search(f)
        if m:
            exp_files[(int(m.group(1)), int(m.group(2)), int(m.group(3)))] = f
    if not exp_files:
        raise FileNotFoundError(f"no layer_L_expert_E_mp_rank_MM_model_states.pt files in "
                                f"{ckpt_dir} (gate keys present: this is a MoE checkpoint)")
    n_experts = 1 + max(e for _, e, _ in exp_files)
    mp_ranks = sorted({mp for _, _, mp in exp_files})

    def load_expert(moe_l: int, e: int) -> Dict[str, torch.Tensor]:
        shards = []
        for mp in mp_ranks:
            key = (moe_l, e, mp)
            if key not in exp_files:
                raise FileNotFoundError(f"missing expert file layer_{moe_l}_expert_{e}_mp_rank_"
                                        f"{mp:02d}_model_states.pt")
            renamed = {}
            for k, v in _load(os.path.join(ckpt_dir, exp_files[key])).items():
                # Megatron's MLP names, so that the standard partition dims
                # apply (h_to_4h column-parallel on dim 0, 4h_to_h on dim 1)
                for part in ("dense_h_to_4h", "dense_4h_to_h"):
                    if f".{part}." in k or k.startswith(f"{part}."):
                        renamed[f"mlp.{part}." + k.rsplit(".", 1)[-1]] = v
            shards.append(renamed)
        return merge_tp_shards(shards)

    A = lambda x: x.to(dtype).contiguous()
    for p, lid in enumerate(moe_ids):
        ex = [load_expert(p, e) for e in range(n_experts)]
        # the torch Linear gate weight is (E, D); the port's (D, E). It is
        # replicated across tp: checked against the files' expert count here
        gate = _g(layers[lid], "deepspeed_moe.gate.wg.weight").t()
        if gate.shape[-1] != n_experts:
            raise ValueError(f"gate at layer {lid} routes {gate.shape[-1]} experts but "
                             f"{n_experts} expert files were found")
        sd[f"moe.{p}.gate.wg"] = A(gate)
        sd[f"moe.{p}.experts.wi"] = A(torch.stack([e["mlp.dense_h_to_4h.weight"].t()
                                                   for e in ex]))
        sd[f"moe.{p}.experts.bi"] = A(torch.stack([e["mlp.dense_h_to_4h.bias"] for e in ex]))
        sd[f"moe.{p}.experts.wo"] = A(torch.stack([e["mlp.dense_4h_to_h.weight"].t()
                                                   for e in ex]))
        sd[f"moe.{p}.experts.bo"] = A(torch.stack([e["mlp.dense_4h_to_h.bias"] for e in ex]))
    logger.info(f"load_megatron_moe: {len(layers)} layers ({len(moe_ids)} MoE x {n_experts} "
                f"experts), d={config.n_embd}, vocab={config.vocab_size}, heads={n_head} "
                f"(tp={ck.tp_degree}, expert mp={mp_ranks})")
    return config, sd, n_experts
