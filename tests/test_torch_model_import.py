"""Model import in the port: HF llama, BERT and DistilBERT, and dropout masks
per data-parallel rank.

The loaders read HF-shaped state dicts built here from numpy with a seed
(HF's key names, ``nn.Linear`` (out, in)); the port's loader is handed the
config as a dict and torch tensors, the JAX loader an attribute config and
the same values. Configs agree field for field, weights bit for bit (the
JAX loader's layer-stacked leaves against the port's per-layer ones), and
the loaded models' logits within 1e-5 of the largest (fp32 on the CPU):
llama with grouped KV heads, tied and untied, under each ``rope_scaling``
(none, linear, llama3); BERT (``BertForMaskedLM``) and DistilBERT, served
through ``init_inference``'s forward. The loaders' refusals are the JAX
package's. (The exporters and the consolidated HF files:
``test_torch_model_export.py``.)

Dropout: two gloo ranks train one GPT-2 step with dropout and progressive
layer drop, each on its rows of the global batch. Each rank's masks differ
from the other's (before the rank was folded into the seeds they were
equal), the PLD gates agree, each rank's kept share is within 4σ of 1 - p,
and rank 0's masks, like a world-1 engine's, are those of the seeds drawn
before the fix, bit for bit.

This module imports JAX only inside its functions: the spawned ranks import
it.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.module_inject import hf as thf
from tests.torch_world import World

D, H, KV, L, V, P, INTER = 64, 4, 2, 2, 128, 32, 96
ROPES = {"none": None, "linear": {"rope_type": "linear", "factor": 2.0},
         "llama3": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                    "high_freq_factor": 4.0, "original_max_position_embeddings": 16}}
DROP = dict(vocab_size=128, n_positions=16, n_embd=32, n_layer=2, n_head=2, dropout=0.1,
            remat=False, dtype=torch.float32)
DROP_CONFIG = {"train_batch_size": 4, "steps_per_print": 0,
               "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
               "progressive_layer_drop": {"enabled": True, "theta": 0.5, "gamma": 0.001}}


# ------------------------------------------------------------ HF-shaped dicts
class _Draw:
    def __init__(self, seed):
        self.rs, self.sd = np.random.RandomState(seed), {}

    def put(self, name, *shape, one=False):
        x = 0.05 * self.rs.standard_normal(shape)
        self.sd[name] = (x + 1.0 if one else x).astype(np.float32)

    def ln(self, name, bias=True):
        self.put(name + ".weight", D, one=True)
        if bias:
            self.put(name + ".bias", D)

    def linear(self, name, n_out, n_in, bias=True):
        self.put(name + ".weight", n_out, n_in)
        if bias:
            self.put(name + ".bias", n_out)


def hf_llama(seed=0, tied=True, rope=None):
    dr = _Draw(seed)
    dr.put("model.embed_tokens.weight", V, D)
    for i in range(L):
        p = f"model.layers.{i}."
        dr.ln(p + "input_layernorm", bias=False)
        dr.ln(p + "post_attention_layernorm", bias=False)
        dr.linear(p + "self_attn.q_proj", D, D, bias=False)
        dr.linear(p + "self_attn.k_proj", KV * D // H, D, bias=False)
        dr.linear(p + "self_attn.v_proj", KV * D // H, D, bias=False)
        dr.linear(p + "self_attn.o_proj", D, D, bias=False)
        dr.linear(p + "mlp.gate_proj", INTER, D, bias=False)
        dr.linear(p + "mlp.up_proj", INTER, D, bias=False)
        dr.linear(p + "mlp.down_proj", D, INTER, bias=False)
    dr.ln("model.norm", bias=False)
    if tied:
        dr.sd["lm_head.weight"] = dr.sd["model.embed_tokens.weight"].copy()
    else:
        dr.put("lm_head.weight", V, D)
    cfg = {"model_type": "llama", "num_attention_heads": H, "num_key_value_heads": KV,
           "rms_norm_eps": 1e-6, "rope_theta": 50000.0, "max_position_embeddings": P,
           "rope_scaling": rope}
    return cfg, dr.sd


def hf_bert(seed=0):
    dr = _Draw(seed)
    e = "bert.embeddings."
    dr.put(e + "word_embeddings.weight", V, D)
    dr.put(e + "position_embeddings.weight", P, D)
    dr.put(e + "token_type_embeddings.weight", 2, D)
    dr.ln(e + "LayerNorm")
    for i in range(L):
        p = f"bert.encoder.layer.{i}."
        for n in ("query", "key", "value"):
            dr.linear(p + f"attention.self.{n}", D, D)
        dr.linear(p + "attention.output.dense", D, D)
        dr.ln(p + "attention.output.LayerNorm")
        dr.linear(p + "intermediate.dense", INTER, D)
        dr.linear(p + "output.dense", D, INTER)
        dr.ln(p + "output.LayerNorm")
    dr.linear("cls.predictions.transform.dense", D, D)
    dr.ln("cls.predictions.transform.LayerNorm")
    dr.put("cls.predictions.bias", V)
    dr.sd["cls.predictions.decoder.weight"] = dr.sd[e + "word_embeddings.weight"].copy()
    cfg = {"model_type": "bert", "num_attention_heads": H, "intermediate_size": INTER,
           "hidden_act": "gelu", "layer_norm_eps": 1e-12, "max_position_embeddings": P,
           "type_vocab_size": 2, "position_embedding_type": "absolute"}
    return cfg, dr.sd


def hf_distilbert(seed=0):
    dr = _Draw(seed)
    e = "distilbert.embeddings."
    dr.put(e + "word_embeddings.weight", V, D)
    dr.put(e + "position_embeddings.weight", P, D)
    dr.ln(e + "LayerNorm")
    for i in range(L):
        p = f"distilbert.transformer.layer.{i}."
        for n in ("q", "k", "v", "out"):
            dr.linear(p + f"attention.{n}_lin", D, D)
        dr.ln(p + "sa_layer_norm")
        dr.linear(p + "ffn.lin1", INTER, D)
        dr.linear(p + "ffn.lin2", D, INTER)
        dr.ln(p + "output_layer_norm")
    dr.linear("vocab_transform", D, D)
    dr.ln("vocab_layer_norm")
    dr.put("vocab_projector.bias", V)
    dr.sd["vocab_projector.weight"] = dr.sd[e + "word_embeddings.weight"].copy()
    cfg = {"model_type": "distilbert", "n_heads": H, "hidden_dim": INTER, "activation": "gelu",
           "max_position_embeddings": P}
    return cfg, dr.sd


HF_DICTS = {"llama": hf_llama, "bert": hf_bert, "distilbert": hf_distilbert}


def _obj(cfg, sd):
    """What a loader takes: ``.config`` and ``state_dict()``."""
    return types.SimpleNamespace(config=cfg, state_dict=lambda: sd)


def _torch_sd(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _stacked_leaf(jparams, name):
    """The JAX tree's leaf for the port's state-dict ``name``."""
    if name.startswith("blocks."):
        _, i, key = name.split(".")
        return np.asarray(jparams["blocks"][key])[int(i)]
    return np.asarray(jparams[name])


def _jax_tree(sd):
    """The port's per-layer state dict → the JAX package's stacked tree."""
    tree, blocks = {}, {}
    for name, t in sd.items():
        if name.startswith("blocks."):
            _, i, key = name.split(".")
            blocks.setdefault(key, {})[int(i)] = np.asarray(t)
        else:
            tree[name] = np.asarray(t)
    tree["blocks"] = {k: np.stack([v[i] for i in range(len(v))]) for k, v in blocks.items()}
    return tree


def _configs_equal(config, jconfig):
    for f in dataclasses.fields(config):
        got, want = getattr(config, f.name), getattr(jconfig, f.name)
        if f.name == "dtype":
            assert str(got).replace("torch.", "") == np.dtype(want).name
        else:
            assert got == want, f.name


def _load_both(family, cfg, sd):
    from deepspeed_tpu.module_inject import hf as jhf

    model, tsd = thf.load_hf_model(_obj(cfg, _torch_sd(sd)))
    jmodel, jparams = jhf.load_hf_model(_obj(types.SimpleNamespace(**cfg), sd))
    return model, tsd, jmodel, jparams


def _held_to_jax(model, tsd, jmodel, jparams):
    _configs_equal(model.config, jmodel.config)
    assert set(tsd) == ({k for k in jparams if k != "blocks"}
                        | {f"blocks.{i}.{k}" for i in range(L) for k in jparams["blocks"]})
    for name, t in tsd.items():
        assert t.dtype == torch.float32 and t.is_contiguous(), name
        np.testing.assert_array_equal(t.numpy(), _stacked_leaf(jparams, name), err_msg=name)
    model.load_state_dict(tsd, assign=True)           # the key set is the model's
    ids = np.random.RandomState(1).randint(0, V, (2, 16)).astype(np.int32)
    ref = np.asarray(jmodel.apply(jparams, ids))
    with torch.no_grad():
        got = model.apply(torch.from_numpy(ids).long()).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    return ids, got


# ------------------------------------------------------------------ loaders
@pytest.mark.parametrize("rope", sorted(ROPES))
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_load_llama_matches_jax(tied, rope):
    from deepspeed_tpu_torch.models.llama import LlamaModel

    cfg, sd = hf_llama(seed=2, tied=tied, rope=ROPES[rope])
    model, tsd, jmodel, jparams = _load_both("llama", cfg, sd)
    assert type(model) is LlamaModel
    assert model.config.n_kv_head == KV and model.config.tie_embeddings == tied
    assert model.config.rope_scaling == ROPES[rope] and model.config.rms_norm_eps == 1e-6
    ids, logits = _held_to_jax(model, tsd, jmodel, jparams)
    # served from the loaded state dict: greedy tokens equal greedy apply
    engine = deepspeed_tpu_torch.init_inference(
        LlamaModel(model.config), {"dtype": "fp32", "max_tokens": P}, params=tsd, device="cpu")
    prompt = torch.from_numpy(ids[:, :8]).long()
    out = engine.generate(prompt, max_new_tokens=4)
    seq = prompt
    with torch.no_grad():
        for _ in range(4):
            seq = torch.cat([seq, model.apply(seq)[:, -1].argmax(-1, keepdim=True)], dim=1)
    assert torch.equal(out, seq)


@pytest.mark.parametrize("family", ["bert", "distilbert"])
def test_load_bert_and_distilbert_match_jax(family):
    from deepspeed_tpu_torch.models.bert import BertModel

    cfg, sd = HF_DICTS[family](seed=3)
    model, tsd, jmodel, jparams = _load_both(family, cfg, sd)
    assert type(model) is BertModel
    if family == "distilbert":
        assert model.config.type_vocab_size == 1 and not tsd["wtype"].any()
        assert model.config.intermediate_size == INTER
    ids, logits = _held_to_jax(model, tsd, jmodel, jparams)
    engine = deepspeed_tpu_torch.init_inference(BertModel(model.config), {"dtype": "fp32"},
                                                params=tsd, device="cpu")
    assert torch.equal(engine.forward(ids), torch.from_numpy(logits))


def test_loaders_refuse_what_jax_refuses():
    cfg, sd = hf_llama()
    for family, loader in (("llama", thf.load_llama), ("bert", thf.load_bert),
                           ("distilbert", thf.load_distilbert)):
        with pytest.raises(ValueError, match="bare state dict"):
            loader(_torch_sd(HF_DICTS[family]()[1]))

    def no_conversion():
        raise AssertionError("the state dict was read")

    yarn = {**cfg, "rope_scaling": {"rope_type": "yarn", "factor": 4.0}}
    with pytest.raises(NotImplementedError, match="rope_scaling type 'yarn'"):
        thf.load_llama(types.SimpleNamespace(config=yarn, state_dict=no_conversion))
    cfg, sd = hf_bert()
    untied = {**sd, "cls.predictions.decoder.weight": sd["cls.predictions.decoder.weight"] + 1}
    with pytest.raises(NotImplementedError, match="untied BERT MLM decoder"):
        thf.load_bert(_obj(cfg, untied))
    for pos in ("relative_key", "relative_key_query"):
        with pytest.raises(NotImplementedError, match="position_embedding_type"):
            thf.load_bert(_obj({**cfg, "position_embedding_type": pos}, sd))
    with pytest.raises(NotImplementedError, match="hidden_act 'silu'"):
        thf.load_bert(_obj({**cfg, "hidden_act": "silu"}, sd))
    bare = {k: v for k, v in sd.items() if not k.startswith("cls.")}
    with pytest.raises(NotImplementedError, match="BertForMaskedLM"):
        thf.load_bert(_obj(cfg, bare))
    cfg, sd = hf_distilbert()
    untied = {**sd, "vocab_projector.weight": sd["vocab_projector.weight"] * 2}
    with pytest.raises(NotImplementedError, match="untied DistilBERT"):
        thf.load_distilbert(_obj(cfg, untied))
    with pytest.raises(NotImplementedError, match="loading architecture 'mpt'"):
        thf.load_hf_model(_obj({"model_type": "mpt"}, sd))


def test_loaders_keep_tensors_on_their_device_and_cast():
    cfg, sd = hf_llama()
    c, out = thf.load_llama(_obj(cfg, _torch_sd(sd)), dtype=torch.bfloat16)
    assert c.dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 and t.device.type == "cpu" for t in out.values())


# ------------------------------------------------------------------ dropout
def _dropout_step(rank: int = 0, world: int = 1):
    """One engine step of DROP with dropout and PLD on, recording every mask
    (the ``dropout`` calls' kept elements), seed and PLD gate drawn; on the
    ranks of the current process group when there is one, each with its
    rows ``rank::world`` of the global batch, as the data loader splits it."""
    record = {"masks": [], "seeds": [], "gates": []}
    orig_drop, orig_gates = tgpt2.dropout, tgpt2.pld_gates

    def drop(x, p, seed):
        y = orig_drop(x, p, seed)
        record["masks"].append((y != 0).detach().clone())
        record["seeds"].append(seed)
        return y

    def gates(theta, n_layer, generator):
        g = orig_gates(theta, n_layer, generator)
        record["gates"].append(g.clone())
        return g

    tgpt2.dropout, tgpt2.pld_gates = drop, gates
    try:
        model = tgpt2.GPT2Model(tgpt2.GPT2Config(**DROP))
        model.init_params(torch.Generator().manual_seed(0))
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=DROP_CONFIG,
                                                    device="cpu")
        ids = np.random.RandomState(3).randint(0, DROP["vocab_size"], (4, DROP["n_positions"]))
        engine.train_batch({"input_ids": ids[rank::world]})
        record["seed"] = engine._config.seed
    finally:
        tgpt2.dropout, tgpt2.pld_gates = orig_drop, orig_gates
    return record


def _dropout_rank(rank, world, out_dir):
    return _dropout_step(rank, world)


def _masks_before_the_fix(record):
    """The masks the seeds drawn before the rank was folded in give: the
    step's generator (the config's seed, step 0, microbatch 0), 1 + 2L
    seeds, each mask ``rand < 1 - p`` from a generator of its seed."""
    gen = torch.Generator().manual_seed(record["seed"] * 1_000_003 * 1_009)
    seeds = torch.randint(0, 2 ** 62, (1 + 2 * DROP["n_layer"],), generator=gen).tolist()
    masks = [torch.rand(m.shape, generator=torch.Generator().manual_seed(s)) < 1 - DROP["dropout"]
             for m, s in zip(record["masks"], seeds)]
    return seeds, masks


@pytest.fixture(scope="module", autouse=True)
def dropout_world(tmp_path_factory):
    """Two gloo ranks running ``_dropout_step``, started before the module's
    first test and joined by the dropout test."""
    world = World(_dropout_rank, 2, str(tmp_path_factory.mktemp("dropout_world")))
    yield world
    world.join()


def test_dropout_masks_differ_across_ranks_and_pld_gates_agree(dropout_world):
    ranks = dropout_world.join()
    alone = _dropout_step()
    n_sites = 1 + 2 * DROP["n_layer"]
    p = DROP["dropout"]
    for r in ranks:
        assert len(r["masks"]) == n_sites and len(r["gates"]) == 1
    for m0, m1 in zip(ranks[0]["masks"], ranks[1]["masks"]):
        assert m0.shape == m1.shape and not torch.equal(m0, m1)
    assert torch.equal(ranks[0]["gates"][0], ranks[1]["gates"][0])
    for r in ranks + [alone]:
        kept = torch.cat([m.flatten() for m in r["masks"]]).float()
        sigma = (p * (1 - p) / kept.numel()) ** 0.5
        assert abs(kept.mean().item() - (1 - p)) <= 4 * sigma
    # rank 0 of two, and a world of one, draw the masks of before the fix
    for r in (ranks[0], alone):
        seeds, masks = _masks_before_the_fix(r)
        assert r["seeds"] == seeds
        for got, want in zip(r["masks"], masks):
            assert torch.equal(got, want)
    assert ranks[1]["seeds"] != ranks[0]["seeds"]
    assert alone["masks"][0].shape[0] == 2 * ranks[0]["masks"][0].shape[0]
