"""Megatron-DeepSpeed checkpoints in the port, against the JAX package.

A 4-layer GPT-2 and a 4-layer MoE GPT-2 (4 experts on blocks 1 and 3) are
written as Megatron-DeepSpeed layer-file directories at tp 1 and 2
(``tests/torch_megatron_files.py``; the MoE gate replicated over the tp
shards, the experts in their own files). The port's ``meg_2d`` math
(partition dims, merge, split, the 2D reshape), ``DeepSpeedCheckpoint``'s
index and merged layers, and ``load_megatron_gpt`` / ``load_megatron_moe``
equal the JAX package's on the same files, bit for bit (fp32).
``init_inference(model=None, checkpoint=<dir>, checkpoint_config={"type":
"Megatron" | "Megatron-MoE", "n_head": N})`` serves them: its logits are the
JAX engine's on the same directory within 1e-5 of the largest, and its
greedy tokens those of the weights served from the original state dict.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint import DeepSpeedCheckpoint, load_megatron_gpt, \
    load_megatron_moe, meg_2d_parallel_map, reshape_meg_2d_parallel
from deepspeed_tpu_torch.checkpoint import meg_2d
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.gpt2_moe import MoEGPT2
from tests.torch_megatron_files import write_megatron

CFG = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=4, n_head=4, remat=False)
EXPERTS = 4
SERVE = {"dtype": "float32", "max_out_tokens": 32}


def _config():
    return tgpt2.GPT2Config(**CFG, dtype=torch.float32)


def _dense_sd():
    return tgpt2.GPT2Model(_config()).init_params(torch.Generator().manual_seed(3)).state_dict()


def _moe_sd():
    model = MoEGPT2(_config(), num_experts=EXPERTS, drop_tokens=False)
    return model.init_params(torch.Generator().manual_seed(4)).state_dict()


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("megatron")
    dense, moe = _dense_sd(), _moe_sd()
    out = {"dense": dense, "moe": moe}
    for tp in (1, 2):
        write_megatron(dense, CFG["n_layer"], CFG["n_head"], str(root / f"gpt_tp{tp}"), tp=tp)
        write_megatron(moe, CFG["n_layer"], CFG["n_head"], str(root / f"moe_tp{tp}"), tp=tp,
                       moe=True)
        out[f"gpt_tp{tp}"], out[f"moe_tp{tp}"] = (str(root / f"gpt_tp{tp}"),
                                                  str(root / f"moe_tp{tp}"))
    return out


def _equal(got, want, name=""):
    np.testing.assert_array_equal(torch.as_tensor(got).numpy(), np.asarray(want), err_msg=name)


def test_meg_2d_reshape_math_matches_jax():
    from deepspeed_tpu.checkpoint import meg_2d as jmeg

    for name in ("self_attention.dense.weight", "x.mlp.dense_4h_to_h.weight", "weight", "bias",
                 "input_layernorm.bias", "mlp.deepspeed_moe.gate.wg.weight",
                 "position_embeddings.weight", "word_embeddings.weight",
                 "self_attention.query_key_value.weight"):
        assert meg_2d.partition_dim(name) == jmeg.partition_dim(name), name
    assert meg_2d.SEQUENTIAL_LAYERS == jmeg.SEQUENTIAL_LAYERS
    assert meg_2d.LAYER_CONCAT_DIM == jmeg.LAYER_CONCAT_DIM
    tm, jm = meg_2d_parallel_map(2, 4), jmeg.meg_2d_parallel_map(2, 4)
    tm.simple_init()
    jm.simple_init()
    assert tm.map == jm.map and tm.get_data(pp_index=0) == [0, 1, 2, 3]
    assert tm.get_data(tp_index=1) == jm.get_data(tp_index=1) == [1, 5]
    full = {"self_attention.query_key_value.weight": np.arange(32.0).reshape(8, 4),
            "self_attention.dense.weight": np.arange(32.0).reshape(4, 8),
            "input_layernorm.weight": np.arange(4.0)}
    tshards, jshards = meg_2d.split_tp_shards(full, 2), jmeg.split_tp_shards(full, 2)
    for t, j in zip(tshards, jshards):
        assert t.keys() == j.keys()
        for k in t:
            _equal(t[k], j[k], k)
    back = meg_2d.merge_tp_shards(tshards)
    for k in full:
        _equal(back[k], full[k], k)
    bad = [dict(s) for s in tshards]
    bad[1]["input_layernorm.weight"] = bad[1]["input_layernorm.weight"] + 1
    with pytest.raises(ValueError, match="differs across tp shards"):
        meg_2d.merge_tp_shards(bad)
    with pytest.raises(ValueError, match="not divisible"):
        meg_2d.split_tp_shards(full, 3)
    tgrid = reshape_meg_2d_parallel(1, 2, 1, 4, lambda pp, tp: tshards[tp])
    jgrid = jmeg.reshape_meg_2d_parallel(1, 2, 1, 4, lambda pp, tp: jshards[tp])
    for t in range(4):
        a, b = tgrid.get_data(0, t)[0], jgrid.get_data(0, t)[0]
        for k in a:
            _equal(a[k], b[k], k)
    # pp: two stages grouped into one, key sets disjoint
    stages = [{"a.weight": np.ones((2, 2))}, {"b.weight": np.zeros((2, 2))}]
    grid = reshape_meg_2d_parallel(2, 1, 1, 1, lambda pp, tp: stages[pp])
    assert sorted(grid.get_data(0, 0)[0]) == ["a.weight", "b.weight"]
    with pytest.raises(NotImplementedError, match="pp split"):
        reshape_meg_2d_parallel(1, 1, 2, 1, lambda pp, tp: stages[0])


@pytest.mark.parametrize("tp", [1, 2])
def test_deepspeed_checkpoint_index_and_merge_match_jax(dirs, tp):
    from deepspeed_tpu.checkpoint import DeepSpeedCheckpoint as JCheckpoint

    for kind in ("gpt", "moe"):
        t, j = DeepSpeedCheckpoint(dirs[f"{kind}_tp{tp}"]), JCheckpoint(dirs[f"{kind}_tp{tp}"])
        assert t.tp_degree == j.tp_degree == tp and t.num_layers() == j.num_layers() == 4
        assert (t.layer_ids, t.embedding_layer_id, t.final_norm_layer_id,
                t.transformer_layer_ids) == (j.layer_ids, j.embedding_layer_id,
                                             j.final_norm_layer_id, j.transformer_layer_ids)
        pairs = [(t.get_embedding_state(), j.get_embedding_state()),
                 (t.get_final_norm_state(), j.get_final_norm_state())]
        pairs += [(t.get_transformer_state(i), j.get_transformer_state(i)) for i in range(4)]
        for a, b in pairs:
            assert a.keys() == b.keys()
            for k in a:
                _equal(a[k], b[k], k)
    with pytest.raises(ValueError, match="tp_degree"):
        DeepSpeedCheckpoint(dirs[f"gpt_tp{tp}"], tp_degree=3)


def _stacked(jparams, name):
    """The JAX tree's leaf for the port's state-dict ``name``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return np.asarray(jparams["blocks"][parts[2]])[int(parts[1])]
    if parts[0] == "moe":
        node = jparams["moe"]
        for p in parts[2:]:
            node = node[p]
        return np.asarray(node)[int(parts[1])]
    return np.asarray(jparams[name])


def _check_tree(sd, jparams, want):
    for name, tensor in sd.items():
        assert tensor.dtype == torch.float32 and tensor.is_contiguous(), name
        _equal(tensor, _stacked(jparams, name), name)
        if name in want:
            # the written weights come back exactly (the dense MLP of a MoE
            # block is written nowhere: zeros, as in JAX)
            assert torch.equal(tensor, want[name]) or (".fc" in name and not tensor.any()), name


def test_load_megatron_gpt_matches_jax_bit_for_bit(dirs):
    from deepspeed_tpu.checkpoint import load_megatron_gpt as jload

    cfg, sd = load_megatron_gpt(dirs["gpt_tp2"], n_head=CFG["n_head"])
    jcfg, jparams = jload(dirs["gpt_tp2"], n_head=CFG["n_head"])
    for key in ("vocab_size", "n_positions", "n_embd", "n_layer", "n_head", "tie_embeddings"):
        assert getattr(cfg, key) == getattr(jcfg, key) == CFG.get(key, True), key
    assert cfg.dtype == torch.float32
    assert sd.keys() == dirs["dense"].keys()
    _check_tree(sd, jparams, dirs["dense"])
    _, sd1 = load_megatron_gpt(dirs["gpt_tp1"], n_head=CFG["n_head"], dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 and torch.equal(t, sd[k].to(torch.bfloat16))
               for k, t in sd1.items())
    with pytest.raises(ValueError, match="does not divide"):
        load_megatron_gpt(dirs["gpt_tp2"], n_head=5)


def test_load_megatron_moe_tp2_gate_replicated_matches_jax(dirs):
    from deepspeed_tpu.checkpoint import load_megatron_moe as jload

    cfg, sd, n = load_megatron_moe(dirs["moe_tp2"], n_head=CFG["n_head"])
    jcfg, jparams, jn = jload(dirs["moe_tp2"], n_head=CFG["n_head"])
    assert n == jn == EXPERTS and cfg.n_layer == jcfg.n_layer == 4
    assert sd["moe.0.gate.wg"].shape == (CFG["n_embd"], EXPERTS)
    assert sd.keys() == dirs["moe"].keys()
    _check_tree(sd, jparams, dirs["moe"])
    _, sd1, _ = load_megatron_moe(dirs["moe_tp1"], n_head=CFG["n_head"])
    assert all(torch.equal(t, sd[k]) for k, t in sd1.items())
    with pytest.raises(ValueError, match="Switch interleave"):
        load_megatron_moe(dirs["gpt_tp1"], n_head=CFG["n_head"])


def _jax_served_logits(ckpt, kind, ids):
    """The JAX engine on the same directory, its model given in fp32 (a JAX
    model built from a Megatron checkpoint computes in its config's
    default, bf16)."""
    import dataclasses

    import jax.numpy as jnp

    import deepspeed_tpu
    from deepspeed_tpu.checkpoint import load_megatron_gpt as jload
    from deepspeed_tpu.checkpoint import load_megatron_moe as jload_moe
    from deepspeed_tpu.comm import comm
    from deepspeed_tpu.models.gpt2 import GPT2Model
    from deepspeed_tpu.models.gpt2_moe import MoEGPT2 as JMoEGPT2

    comm.cdb = None
    moe = kind == "Megatron-MoE"
    jcfg = (jload_moe if moe else jload)(ckpt, n_head=CFG["n_head"])[0]
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    model = JMoEGPT2(jcfg, num_experts=EXPERTS, ep_size=1, drop_tokens=False) \
        if moe else GPT2Model(jcfg)
    engine = deepspeed_tpu.init_inference(model, config={
        "checkpoint": ckpt, "checkpoint_config": {"type": kind, "n_head": CFG["n_head"]},
        "dtype": "float32", "max_out_tokens": 32})
    return np.asarray(engine.forward(ids))


@pytest.mark.parametrize("kind,key", [("Megatron", "gpt_tp2"), ("Megatron-MoE", "moe_tp2")])
def test_init_inference_serves_a_megatron_dir_like_jax(dirs, kind, key):
    served = deepspeed_tpu_torch.init_inference(
        config={**SERVE, "checkpoint": dirs[key],
                "checkpoint_config": {"type": kind, "n_head": CFG["n_head"]}}, device="cpu")
    model = served.module
    moe = kind == "Megatron-MoE"
    assert type(model) is (MoEGPT2 if moe else tgpt2.GPT2Model)
    assert model.config.use_flash_decode and served._config.checkpoint is None
    if moe:
        assert model.num_experts == EXPERTS and not model.moe[0].gate.drop_tokens
    ids = np.random.RandomState(2).randint(0, CFG["vocab_size"], (2, 12)).astype(np.int64)
    got = served(ids).numpy()
    ref = _jax_served_logits(dirs[key], kind, ids.astype(np.int32))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    # the same weights served from the port's state dict: the same tokens
    want = dirs["moe" if moe else "dense"]
    cls = (lambda c: MoEGPT2(c, num_experts=EXPERTS, drop_tokens=False)) if moe \
        else tgpt2.GPT2Model
    direct = deepspeed_tpu_torch.init_inference(
        cls(tgpt2.GPT2Config(**CFG, dtype=torch.float32, use_flash_decode=True)), SERVE,
        params={k: v.clone() for k, v in want.items()}, device="cpu")
    prompt = torch.from_numpy(ids[:, :8])
    assert torch.equal(served.generate(prompt, max_new_tokens=6),
                       direct.generate(prompt, max_new_tokens=6))
