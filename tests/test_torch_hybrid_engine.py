"""The port's hybrid engine (the RLHF actor) against the JAX package.

One JAX hybrid engine runs DeepSpeed-Chat's loop on a 2-layer fp32 GPT-2
with MoQ armed from step 1: generate greedily from 8 prompts, train on the
sequences with the loss masked to the answers, twice. The port's engine,
from the same weights, must give the same tokens (the second generate under
the compressed weights) and losses. The rest is held to the JAX engine's
unit behaviour: ``initialize`` returns the hybrid engine, generation reads
the live params, ``max_out_tokens``, the inference-protocol refusal, the
first call of a key left out of the accounting, the hybrid block's keys,
and ZeRO stage 3 at a world of one against stage 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime.hybrid_engine import DeepSpeedHybridEngine as JHybrid
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.simple import SimpleModel
from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine

SMALL = dict(vocab_size=256, n_positions=64, n_embd=32, n_layer=2, n_head=2, remat=False,
             use_flash_attention=False)
MOQ = {"weight_quantization": {
    "shared_parameters": {"enabled": True, "schedule_offset": 1, "quantization_period": 4},
    "different_groups": {"q": {"params": {"start_bits": 6, "target_bits": 4},
                               "modules": ["blocks"]}}}}
PROMPT, NEW = 8, 8


def _config(**extra):
    return {"train_batch_size": 8, "steps_per_print": 0,
            "optimizer": {"type": "AdamW", "params": {"lr": 5e-3}},
            "hybrid_engine": {"enabled": True, "max_out_tokens": 64}, **extra}


def _np_params(seed=0):
    shapes = jax.eval_shape(lambda: jgpt2.GPT2Model(jgpt2.GPT2Config(
        **SMALL, dtype=jnp.float32)).init_params(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda s: (0.3 * rs.randn(*s.shape)).astype(np.float32), shapes)


def _port(np_params, **extra):
    model = tgpt2.params_from_jax(np_params, tgpt2.GPT2Config(**SMALL, dtype=torch.float32))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=_config(**extra),
                                                device="cpu")
    return engine


def _rlhf(engine, prompts, iters=2):
    """generate → mask the answers → train, ``iters`` times: the sequences
    and losses."""
    seqs, losses = [], []
    for _ in range(iters):
        engine.eval()
        out = np.asarray(engine.generate(prompts, max_new_tokens=NEW))
        loss_mask = np.zeros(out.shape, np.float32)
        loss_mask[:, PROMPT:] = 1.0
        engine.train()
        losses.append(float(engine.train_batch({"input_ids": out.astype(np.int32),
                                                "loss_mask": loss_mask})))
        seqs.append(out)
    return seqs, losses


@pytest.fixture(scope="module")
def runs():
    np_params = _np_params()
    prompts = np.random.RandomState(0).randint(0, SMALL["vocab_size"],
                                               size=(8, PROMPT)).astype(np.int32)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.GPT2Model(jgpt2.GPT2Config(**SMALL, dtype=jnp.float32)),
        model_parameters=jax.tree.map(jnp.asarray, np_params),
        config=_config(compression_training=MOQ))
    teng = _port(np_params, compression_training=MOQ)
    return {"jax": _rlhf(jeng, prompts), "port": _rlhf(teng, prompts), "jeng": jeng,
            "teng": teng, "np_params": np_params, "prompts": prompts}


def test_initialize_returns_the_hybrid_engine(runs):
    assert isinstance(runs["jeng"], JHybrid)
    assert isinstance(runs["teng"], DeepSpeedHybridEngine)
    assert runs["teng"].eval() is runs["teng"] and runs["teng"].train(False) is runs["teng"]


@pytest.mark.parametrize("it", [0, 1])
def test_rlhf_loop_tokens_and_losses_match_jax(runs, it):
    (jseqs, jlosses), (tseqs, tlosses) = runs["jax"], runs["port"]
    np.testing.assert_array_equal(tseqs[it], jseqs[it])
    np.testing.assert_array_equal(tseqs[it][:, :PROMPT], runs["prompts"])
    np.testing.assert_allclose(tlosses[it], jlosses[it], rtol=1e-5)


def test_generate_under_armed_compression_matches_jax(runs):
    """The second generate runs at step 1, inside MoQ's 6-bit window: the
    port read weights compressed for step 1 (at most 2^6 levels over the
    stacked leaf), and its greedy tokens equal JAX's."""
    teng = runs["teng"]
    assert teng._compression_at == 1 and teng._compressed.refreshes == 2
    stacked = torch.stack([teng._compressed.eff[f"blocks.{i}.fc_w"] for i in range(2)])
    raw = torch.stack([dict(teng.module.named_parameters())[f"blocks.{i}.fc_w"].detach()
                       for i in range(2)])
    scale = stacked.abs().max() / 31
    assert len(torch.unique(torch.round(stacked / scale))) <= 2 ** 6
    assert len(torch.unique(raw)) > 2 ** 6
    np.testing.assert_array_equal(runs["port"][0][1], runs["jax"][0][1])


def test_hybrid_stats_leave_out_a_keys_first_call(runs):
    """Two calls of one key: the first (JAX's compile, the port's capture on
    the card) counts neither latency nor tokens."""
    for eng in (runs["jeng"], runs["teng"]):
        stats = eng.hybrid_stats()
        assert stats["generate_calls"] == 2 and stats["generated_tokens"] == 8 * NEW
        assert stats["generate_latency_s"] > 0
    assert runs["teng"].hybrid_stats()["captures"] == 0        # the CPU loop is eager


def test_generate_reflects_training():
    engine = _port(_np_params(1))
    prompts = np.random.RandomState(1).randint(0, SMALL["vocab_size"], size=(8, PROMPT))
    out0 = np.asarray(engine.generate(prompts, max_new_tokens=6, seed=7))
    batch = {"input_ids": np.random.RandomState(2).randint(0, SMALL["vocab_size"],
                                                           size=(8, 32))}
    for _ in range(4):
        engine.train_batch(batch)
    out1 = np.asarray(engine.generate(prompts, max_new_tokens=6, seed=7))
    assert out0.shape == out1.shape and not np.array_equal(out0, out1)


def test_max_out_tokens_and_the_inference_protocol():
    engine = _port(_np_params())
    with pytest.raises(ValueError, match="max_out_tokens"):
        engine.generate(np.zeros((2, 60), np.int64), max_new_tokens=8)
    simple, *_ = deepspeed_tpu_torch.initialize(
        model=SimpleModel(hidden_dim=8, nlayers=2).init_params(torch.Generator()),
        device="cpu", config={"train_batch_size": 8, "hybrid_engine": {"enabled": True},
                              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}})
    with pytest.raises(NotImplementedError, match="inference protocol"):
        simple.generate(np.zeros((2, 4), np.int64))


def test_hybrid_block_keys():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    cfg = DeepSpeedConfig({"train_batch_size": 8, "hybrid_engine": {
        "enabled": True, "pin_parameters": False, "tp_gather_partition_size": 4,
        "release_inference_cache": False}})
    assert cfg.hybrid_engine.max_out_tokens == 512 and cfg.hybrid_engine.pin_parameters is False
    with pytest.raises(NotImplementedError, match="inference_tp_size"):
        DeepSpeedConfig({"train_batch_size": 8, "hybrid_engine": {"inference_tp_size": 2}})
    with pytest.raises(ValueError, match="release_inference_cache"):
        DeepSpeedConfig({"train_batch_size": 8, "hybrid_engine": {
            "release_inference_cache": True}})
    with pytest.raises(ValueError, match="max_out_tokens"):
        DeepSpeedConfig({"train_batch_size": 8, "hybrid_engine": {"max_out_tokens": 0}})


def test_stage_3_at_world_1_matches_stage_0():
    """Every unit gathered per module (persistence threshold 0): the same
    tokens and losses as stage 0."""
    np_params = _np_params(2)
    prompts = np.random.RandomState(3).randint(0, SMALL["vocab_size"], size=(8, PROMPT))
    want = _rlhf(_port(np_params), prompts)
    eng3 = _port(np_params, zero_optimization={"stage": 3,
                                               "stage3_param_persistence_threshold": 0})
    assert all(eng3._zero.fetched)
    got = _rlhf(eng3, prompts)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
