"""The port's HF language-model loaders against the JAX package's.

Each of the six loaders (GPT-2, OPT, BLOOM, GPT-NeoX, GPT-Neo, GPT-J) reads
an HF-shaped state dict built here from numpy with a seed: HF's key names
and tensor shapes (``nn.Linear`` (out, in), GPT-2's Conv1D (in, out),
BLOOM's and NeoX's head-interleaved ``query_key_value``, OPT's position
table with its 2 extra rows, GPT-J's bias-free attention and head bias). The
port's loader is handed the config as a dict (the card's machine has no
``transformers``) and torch tensors; the JAX loader an attribute config and
the same values. The configs agree switch for switch, the weights bit for
bit in fp32 (the JAX loader's layer-stacked leaves against the port's
per-layer ones), and the logits of the loaded models through both packages
within 1e-5 of the largest (fp32 on the CPU). ``init_inference`` serves
each loaded model: greedy tokens equal greedy decoding by ``apply``.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.module_inject import hf as jhf
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.module_inject import hf as thf

D, H, L, V, P = 64, 4, 2, 128, 32
FAMILIES = ("gpt2", "opt", "bloom", "gpt_neox", "gpt_neo", "gptj")
SWITCHES = ("vocab_size", "n_positions", "n_embd", "n_layer", "n_head", "activation", "alibi",
            "embed_layernorm", "rotary_pct", "rotary_theta", "rotary_interleaved",
            "parallel_residual", "tie_embeddings", "lm_head_bias", "attention_layers",
            "window_size")


def hf_shaped(family, seed=0, d=D, h=H, layers=L, vocab=V, positions=P):
    """(HF config dict, state dict of numpy fp32 arrays) of ``family``."""
    rs = np.random.RandomState(seed)
    sd = {}

    def put(name, *shape, scale=0.05, one=False):
        sd[name] = (np.ones(shape) + scale * rs.standard_normal(shape) if one
                    else scale * rs.standard_normal(shape)).astype(np.float32)

    def ln(name):
        put(name + ".weight", d, one=True)
        put(name + ".bias", d)

    def linear(name, n_out, n_in, bias=True):
        put(name + ".weight", n_out, n_in)
        if bias:
            put(name + ".bias", n_out)

    if family == "gpt2":
        put("transformer.wte.weight", vocab, d)
        put("transformer.wpe.weight", positions, d)
        for i in range(layers):
            p = f"transformer.h.{i}."
            ln(p + "ln_1")
            ln(p + "ln_2")
            for name, n_in, n_out in (("attn.c_attn", d, 3 * d), ("attn.c_proj", d, d),
                                      ("mlp.c_fc", d, 4 * d), ("mlp.c_proj", 4 * d, d)):
                put(p + name + ".weight", n_in, n_out)           # Conv1D: (in, out)
                put(p + name + ".bias", n_out)
        ln("transformer.ln_f")
        sd["lm_head.weight"] = sd["transformer.wte.weight"].copy()
        cfg = {"model_type": "gpt2", "n_head": h}
    elif family == "opt":
        put("model.decoder.embed_tokens.weight", vocab, d)
        put("model.decoder.embed_positions.weight", positions + 2, d)
        for i in range(layers):
            p = f"model.decoder.layers.{i}."
            for n in "qkv":
                linear(p + f"self_attn.{n}_proj", d, d)
            linear(p + "self_attn.out_proj", d, d)
            ln(p + "self_attn_layer_norm")
            ln(p + "final_layer_norm")
            linear(p + "fc1", 4 * d, d)
            linear(p + "fc2", d, 4 * d)
        ln("model.decoder.final_layer_norm")
        sd["lm_head.weight"] = sd["model.decoder.embed_tokens.weight"].copy()
        cfg = {"model_type": "opt", "num_attention_heads": h, "hidden_size": d,
               "word_embed_proj_dim": d, "activation_function": "relu",
               "do_layer_norm_before": True}
    elif family == "bloom":
        put("transformer.word_embeddings.weight", vocab, d)
        ln("transformer.word_embeddings_layernorm")
        for i in range(layers):
            p = f"transformer.h.{i}."
            ln(p + "input_layernorm")
            ln(p + "post_attention_layernorm")
            linear(p + "self_attention.query_key_value", 3 * d, d)
            linear(p + "self_attention.dense", d, d)
            linear(p + "mlp.dense_h_to_4h", 4 * d, d)
            linear(p + "mlp.dense_4h_to_h", d, 4 * d)
        ln("transformer.ln_f")
        sd["lm_head.weight"] = sd["transformer.word_embeddings.weight"].copy()
        cfg = {"model_type": "bloom", "n_head": h}
    elif family == "gpt_neox":
        put("gpt_neox.embed_in.weight", vocab, d)
        for i in range(layers):
            p = f"gpt_neox.layers.{i}."
            ln(p + "input_layernorm")
            ln(p + "post_attention_layernorm")
            linear(p + "attention.query_key_value", 3 * d, d)
            linear(p + "attention.dense", d, d)
            linear(p + "mlp.dense_h_to_4h", 4 * d, d)
            linear(p + "mlp.dense_4h_to_h", d, 4 * d)
        ln("gpt_neox.final_layer_norm")
        put("embed_out.weight", vocab, d)
        cfg = {"model_type": "gpt_neox", "num_attention_heads": h, "rotary_pct": 0.25,
               "rotary_emb_base": 10000, "use_parallel_residual": True, "hidden_act": "gelu",
               "max_position_embeddings": positions}
    elif family == "gpt_neo":
        put("transformer.wte.weight", vocab, d)
        put("transformer.wpe.weight", positions, d)
        for i in range(layers):
            p = f"transformer.h.{i}."
            ln(p + "ln_1")
            ln(p + "ln_2")
            for n in "qkv":
                linear(p + f"attn.attention.{n}_proj", d, d, bias=False)
            linear(p + "attn.attention.out_proj", d, d)
            linear(p + "mlp.c_fc", 4 * d, d)
            linear(p + "mlp.c_proj", d, 4 * d)
        ln("transformer.ln_f")
        sd["lm_head.weight"] = sd["transformer.wte.weight"].copy()
        cfg = {"model_type": "gpt_neo", "num_heads": h, "window_size": 8,
               "attention_layers": ["global", "local"] * (layers // 2),
               "max_position_embeddings": positions, "activation_function": "gelu_new"}
    else:
        put("transformer.wte.weight", vocab, d)
        for i in range(layers):
            p = f"transformer.h.{i}."
            ln(p + "ln_1")
            for n in "qkv":
                linear(p + f"attn.{n}_proj", d, d, bias=False)
            linear(p + "attn.out_proj", d, d, bias=False)
            linear(p + "mlp.fc_in", 4 * d, d)
            linear(p + "mlp.fc_out", d, 4 * d)
        ln("transformer.ln_f")
        linear("lm_head", vocab, d)
        cfg = {"model_type": "gptj", "n_head": h, "rotary_dim": (d // h) // 2,
               "n_positions": positions}
    return cfg, sd


def _hf_object(cfg, sd):
    """What a loader takes: an object with ``.config`` and ``state_dict()``."""
    return types.SimpleNamespace(config=cfg, state_dict=lambda: sd)


def _loaded(family, seed=0):
    cfg, sd = hf_shaped(family, seed)
    tcfg, tsd = thf.load_hf_model(
        _hf_object(cfg, {k: torch.from_numpy(v) for k, v in sd.items()}))
    jcfg, jparams = jhf.load_hf_model(_hf_object(types.SimpleNamespace(**cfg), sd))
    return tcfg, tsd, jcfg, jparams


@pytest.mark.parametrize("family", FAMILIES)
def test_loader_matches_jax_bit_for_bit(family):
    model, sd, jmodel, jparams = _loaded(family)
    assert type(model) is tgpt2.GPT2Model and isinstance(jmodel, jgpt2.GPT2Model)
    for key in SWITCHES:
        assert getattr(model.config, key) == getattr(jmodel.config, key), key
    blocks = jparams["blocks"]
    assert set(sd) == ({k for k in jparams if k != "blocks"}
                       | {f"blocks.{i}.{k}" for i in range(L) for k in blocks})
    for name, t in sd.items():
        if name.startswith("blocks."):
            _, i, key = name.split(".")
            ref = np.asarray(blocks[key])[int(i)]
        else:
            ref = np.asarray(jparams[name])
        assert t.dtype == torch.float32 and t.is_contiguous(), name
        np.testing.assert_array_equal(t.numpy(), ref, err_msg=name)
    model.load_state_dict(sd, assign=True)          # the key set is the model's


@pytest.mark.parametrize("family", FAMILIES)
def test_loaded_logits_match_jax_and_serve(family):
    model, sd, jmodel, jparams = _loaded(family, seed=1)
    model.load_state_dict(sd, assign=True)
    ids = np.random.RandomState(1).randint(0, V, (2, 20)).astype(np.int32)
    ref = np.asarray(jmodel.apply(jparams, jnp.asarray(ids)))
    with torch.no_grad():
        got = model.apply(torch.from_numpy(ids)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()

    # served from the loaded state dict: greedy tokens equal greedy apply
    engine = deepspeed_tpu_torch.init_inference(
        tgpt2.GPT2Model(model.config), {"dtype": "fp32", "max_tokens": 32}, params=sd,
        device="cpu")
    prompt = torch.from_numpy(ids[:, :8]).long()
    out = engine.generate(prompt, max_new_tokens=6)
    seq = prompt
    with torch.no_grad():
        for _ in range(6):
            seq = torch.cat([seq, model.apply(seq)[:, -1].argmax(-1, keepdim=True)], dim=1)
    assert torch.equal(out, seq)


def test_loader_switches_are_the_jax_ones():
    """OPT's 2 offset rows dropped, GPT-J's ln_1 in the ln2 slots and its
    zero attention biases, GPT-Neo's sqrt(dh) in q_w, the NeoX rotary base
    under its new name, and the errors of the JAX loaders."""
    cfg, sd = hf_shaped("opt")
    c, out = thf.load_opt(_hf_object(cfg, sd))
    np.testing.assert_array_equal(out["wpe"].numpy(),
                                  sd["model.decoder.embed_positions.weight"][2:])
    assert c.n_positions == P and c.activation == "relu"
    cfg, sd = hf_shaped("gptj")
    c, out = thf.load_gptj(_hf_object(cfg, sd))
    assert torch.equal(out["blocks.1.ln2_g"], out["blocks.1.ln1_g"])
    assert not out["blocks.0.qkv_b"].any() and not out["blocks.0.proj_b"].any()
    assert c.rotary_pct == 0.5 and c.rotary_interleaved and c.lm_head_bias
    cfg, sd = hf_shaped("gpt_neo")
    c, out = thf.load_gptneo(_hf_object(cfg, sd))
    q = sd["transformer.h.0.attn.attention.q_proj.weight"].T * np.float32(np.sqrt(D // H))
    np.testing.assert_array_equal(out["blocks.0.qkv_w"][:, :D].numpy(), q)
    cfg, sd = hf_shaped("gpt_neox")
    c, _ = thf.load_gptneox(_hf_object({**cfg, "rope_theta": 25000.0}, sd))
    assert c.rotary_theta == 25000.0 and c.parallel_residual and not c.tie_embeddings
    for family, loader in (("bloom", thf.load_bloom), ("gptj", thf.load_gptj),
                           ("gpt_neox", thf.load_gptneox), ("opt", thf.load_opt),
                           ("gpt_neo", thf.load_gptneo)):
        with pytest.raises(ValueError, match="bare state dict"):
            loader(hf_shaped(family)[1])
    cfg, sd = hf_shaped("opt")
    with pytest.raises(NotImplementedError, match="post-LN"):
        thf.load_opt(_hf_object({**cfg, "do_layer_norm_before": False}, sd))
    # GPT-2 takes a bare state dict: heads of 64
    c, _ = thf.load_gpt2(hf_shaped("gpt2")[1])
    assert c.n_head == D // 64


def test_loaders_keep_tensors_on_their_device_and_cast():
    cfg, sd = hf_shaped("gpt_neox")
    c, out = thf.load_gptneox(_hf_object(cfg, {k: torch.from_numpy(v) for k, v in sd.items()}),
                              dtype=torch.bfloat16)
    assert c.dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 and t.device.type == "cpu" for t in out.values())
