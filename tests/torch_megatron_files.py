"""Write a Megatron-DeepSpeed layer-file checkpoint directory for the port's tests.

From a ``GPT2Model`` or ``MoEGPT2`` state dict of the port (per-layer
``blocks.<i>.*``, ``moe.<p>.*``), as Megatron-DeepSpeed saves it: the qkv
rows in (head, 3, dh) order, every ``nn.Linear`` weight (out, in), the word
embedding and the column-parallel weights split over ``tp`` on dim 0, the
row-parallel ones (``self_attention.dense``, ``mlp.dense_4h_to_h``) on dim
1, the rest (norms, their biases, the position table, the MoE gate) copied
to every shard. The MoE blocks (every other one) hold the gate in their
layer file and no dense MLP; their experts are in
``layer_{L}_expert_{E}_mp_rank_{MM}_model_states.pt`` files.
"""

import os

import torch

EXPERT_PREFIX = "model.decoder.mlp.deepspeed_moe.experts.deepspeed_experts"


def _save(out_dir, name, full, tp, dims):
    """``full`` ({key: tensor}) split over ``tp`` by ``dims`` ({key: dim or
    None}) into ``name.format(t=...)``, one tensor of its own per shard."""
    for t in range(tp):
        shard = {k: (v if dims[k] is None else torch.chunk(v, tp, dim=dims[k])[t]).clone()
                 for k, v in full.items()}
        torch.save(shard, os.path.join(out_dir, name.format(t=t)))


def write_megatron(sd, n_layer, n_head, out_dir, tp=1, moe=False):
    """Write ``sd`` (the port's state dict, tied head) as Megatron layer files
    over ``tp`` shards into ``out_dir``; ``moe``: the odd blocks are MoE
    blocks of ``sd``'s ``moe.<p>.*`` banks."""
    os.makedirs(out_dir, exist_ok=True)
    d = sd["wte"].shape[1]
    dh = d // n_head
    T = lambda x: x.t().contiguous()
    _save(out_dir, "layer_00-model_{t:02d}-model_states.pt",
          {"word_embeddings.weight": sd["wte"], "position_embeddings.weight": sd["wpe"]}, tp,
          {"word_embeddings.weight": 0, "position_embeddings.weight": None})
    for i in range(n_layer):
        b = lambda k: sd[f"blocks.{i}.{k}"]
        full = {
            "input_layernorm.weight": b("ln1_g"), "input_layernorm.bias": b("ln1_b"),
            # [q | k | v] columns of all heads → rows in (head, 3, dh) order
            "self_attention.query_key_value.weight":
                b("qkv_w").t().reshape(3, n_head, dh, d).transpose(0, 1).reshape(3 * d, d),
            "self_attention.query_key_value.bias":
                b("qkv_b").reshape(3, n_head, dh).transpose(0, 1).reshape(3 * d),
            "self_attention.dense.weight": T(b("proj_w")),
            "self_attention.dense.bias": b("proj_b"),
            "post_attention_layernorm.weight": b("ln2_g"),
            "post_attention_layernorm.bias": b("ln2_b")}
        dims = {k: None for k in full}
        dims.update({"self_attention.query_key_value.weight": 0,
                     "self_attention.query_key_value.bias": 0,
                     "self_attention.dense.weight": 1})
        if moe and i % 2:
            full["mlp.deepspeed_moe.gate.wg.weight"] = T(sd[f"moe.{i // 2}.gate.wg"])
            dims["mlp.deepspeed_moe.gate.wg.weight"] = None
        else:
            full.update({"mlp.dense_h_to_4h.weight": T(b("fc_w")),
                         "mlp.dense_h_to_4h.bias": b("fc_b"),
                         "mlp.dense_4h_to_h.weight": T(b("fc2_w")),
                         "mlp.dense_4h_to_h.bias": b("fc2_b")})
            dims.update({"mlp.dense_h_to_4h.weight": 0, "mlp.dense_h_to_4h.bias": 0,
                         "mlp.dense_4h_to_h.weight": 1, "mlp.dense_4h_to_h.bias": None})
        _save(out_dir, f"layer_{i + 1:02d}-model_{{t:02d}}-model_states.pt", full, tp, dims)
    _save(out_dir, f"layer_{n_layer + 1:02d}-model_{{t:02d}}-model_states.pt",
          {"final_layernorm.weight": sd["lnf_g"], "final_layernorm.bias": sd["lnf_b"]}, tp,
          {"final_layernorm.weight": None, "final_layernorm.bias": None})
    if not moe:
        return
    for p in range(n_layer // 2):
        wi, bi, wo, bo = (sd[f"moe.{p}.experts.{k}"] for k in ("wi", "bi", "wo", "bo"))
        for e in range(wi.shape[0]):
            pfx = f"{EXPERT_PREFIX}.{e}."
            full = {pfx + "dense_h_to_4h.weight": T(wi[e]), pfx + "dense_h_to_4h.bias": bi[e],
                    pfx + "dense_4h_to_h.weight": T(wo[e]), pfx + "dense_4h_to_h.bias": bo[e]}
            _save(out_dir, f"layer_{p}_expert_{e}_mp_rank_{{t:02d}}_model_states.pt", full, tp,
                  {pfx + "dense_h_to_4h.weight": 0, pfx + "dense_h_to_4h.bias": 0,
                   pfx + "dense_4h_to_h.weight": 1, pfx + "dense_4h_to_h.bias": None})
