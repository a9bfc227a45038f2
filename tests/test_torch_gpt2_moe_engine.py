"""The port's MoE GPT-2 against the JAX package's, on the CPU: the engine,
its tags and serving (the model itself: ``test_torch_gpt2_moe.py``, whose
helpers these tests share).

``initialize`` trains the model as the JAX engine does at ZeRO stages 0-3
(3 AdamW steps, gas 2, a loss mask; its weight decay moving the unused
weights alike), at 1e-4. Prefill and decode walk the pairs: without drops
they equal the full forward, and with drops they equal JAX's ``prefill``
and ``decode_step`` logits. The registry resolves ``gpt2-moe-*``; a
trained tag serves bit for bit; a JAX MoE tag continues in the port
through ``state_from_jax``; the knobs of later slices, ZeRO-Infinity and
dropout raise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2_moe as tmoe
from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (apply_flat_state,
                                                                   flatten_state, state_from_jax,
                                                                   wait_for_pending_saves)
from tests.test_torch_gpt2_moe import (E, GAS, ROWS, SEQ, STEPS, _batch, _jax_leaf, _jax_model,
                                       _jax_params, _port, _tcfg, _torch)


# ------------------------------------------------------------------ engine
def _config(stage, **extra):
    return {"train_batch_size": ROWS * GAS, "gradient_accumulation_steps": GAS,
            "steps_per_print": 0, "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 100,
                                  **extra}}


def _params_of(engine):
    return {k[len("params/"):]: v.numpy().copy() for k, v in flatten_state(engine).items()
            if k.startswith("params/")}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine: 3 steps (gas 2, a loss mask), its flat state (what
    its tag holds), 2 steps more."""
    import jax

    import deepspeed_tpu
    from deepspeed_tpu.runtime.checkpoint_engine.engine import _flatten_state

    params = _jax_params(seed=5)
    eng, *_ = deepspeed_tpu.initialize(model=_jax_model(), model_parameters=params,
                                       config=_config(1))
    batch = _batch(ROWS * GAS, seed=5, mask=True)
    ref = {"losses": [float(eng.train_batch(batch)) for _ in range(STEPS)],
           "grad_norm": eng.get_global_grad_norm(),
           "params": jax.tree.map(np.asarray, eng.state.params)}
    flat = {k: np.asarray(v) for k, v in _flatten_state(eng.state).items()}
    ref["continued"] = [float(eng.train_batch(batch)) for _ in range(2)]
    return {"params": params, "ref": ref, "flat": flat, "batch": batch}


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_initialize_trains_like_the_jax_engine(jax_run, stage):
    model = _port(jax_run["params"])
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=_config(stage),
                                                device="cpu")
    assert model.expert_groups is not None and model.expert_groups.ep_size == 1
    losses = [float(engine.train_batch(_torch(jax_run["batch"]))) for _ in range(STEPS)]
    ref = jax_run["ref"]
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    assert engine.get_global_grad_norm() == pytest.approx(ref["grad_norm"], rel=1e-4)
    got = _params_of(engine)
    assert got["moe.experts.wi"].shape == (2, E, 32, 128)
    for name, p in tmoe.params_from_jax(ref["params"], _tcfg(), num_experts=E) \
            .named_parameters():
        stacked = name.startswith("moe.")
        mine = got[f"moe.{name.split('.', 2)[2]}"][int(name.split(".")[1])] if stacked \
            else got[name]
        np.testing.assert_allclose(mine, p.detach().numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=f"stage {stage} {name}")
    # AdamW decays the unused odd-block MLP weights, as the JAX engine does
    before = _jax_leaf(jax_run["params"], "blocks.1.fc_w")
    assert not np.array_equal(got["blocks.1.fc_w"], before)


def test_a_jax_moe_tag_continues_in_the_port(jax_run):
    flat = jax_run["flat"]
    engine, *_ = deepspeed_tpu_torch.initialize(model=_port(_jax_params(seed=6)),
                                                config=_config(1), device="cpu")
    state = state_from_jax(flat)
    assert set(state) == set(flatten_state(engine))
    assert state["opt_state/mu/moe.experts.wi"].shape == (2, E, 32, 128)
    apply_flat_state(engine, state)
    assert engine.global_steps == STEPS
    losses = [float(engine.train_batch(_torch(jax_run["batch"]))) for _ in range(2)]
    np.testing.assert_allclose(losses, jax_run["ref"]["continued"], rtol=1e-4)


def test_a_trained_tag_is_served_bit_for_bit(tmp_path):
    model = tmoe.MoEGPT2(_tcfg(), num_experts=E).init_params(torch.Generator().manual_seed(7))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=_config(3), device="cpu")
    for _ in range(2):
        engine.train_batch(_torch(_batch(ROWS * GAS, seed=7)))
    engine.save_checkpoint(str(tmp_path))
    wait_for_pending_saves()
    trained = engine.module_state_dict()
    served = deepspeed_tpu_torch.init_inference(
        tmoe.MoEGPT2(_tcfg(remat=True), num_experts=E),
        config={"checkpoint": str(tmp_path), "dtype": "float32", "max_out_tokens": 32,
                "moe": {"ep_size": 1}}, device="cpu")
    got = served.module.state_dict()
    assert got.keys() == trained.keys() and served.ep_world_size == 1
    assert all(torch.equal(got[n], trained[n]) for n in got)
    ids = torch.from_numpy(_batch(2, seed=8)["input_ids"][:, :8]).long()
    with torch.no_grad():
        np.testing.assert_array_equal(served(ids).numpy(), engine.module.apply(ids).numpy())
    out = served.generate(ids, max_new_tokens=4)
    assert out.shape == (2, 12) and torch.equal(out[:, :8], ids)


# ----------------------------------------------------------------- serving
def test_prefill_and_decode_equal_the_full_forward_without_drops():
    """Without drops a token's route does not depend on the others in its
    call, so the cached walk gives the full forward's logits."""
    model = _port(_jax_params(seed=9), drop=False)
    ids = torch.from_numpy(_batch(3, seed=9)["input_ids"]).long()
    with torch.no_grad():
        full = model.apply(ids)
        logits, cache = model.prefill(ids[:, :10], model.init_cache(3, SEQ))
        steps = [logits]
        for t in range(10, SEQ):
            logits, cache = model.decode_step(ids[:, t], cache)
            steps.append(logits)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full[:, 9:].numpy(),
                               rtol=1e-4, atol=1e-5)
    assert int(cache["pos"]) == SEQ


def test_prefill_and_decode_match_jax_with_drops():
    import jax
    import jax.numpy as jnp

    params = _jax_params(seed=10, skew=2.0)
    jm, model = _jax_model(), _port(params)
    # compiled once each: op by op the JAX walk takes seconds here
    prefill, decode_step = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    ids = _batch(4, seed=10)["input_ids"]
    j_logits, j_cache = prefill(params, jnp.asarray(ids[:, :12]), jm.init_cache(4, SEQ))
    with torch.no_grad():
        logits, cache = model.prefill(torch.from_numpy(ids[:, :12]).long(),
                                      model.init_cache(4, SEQ))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=1e-4, atol=1e-5)
    for t in range(12, SEQ):
        tok = ids[:, t]
        j_logits, j_cache = decode_step(params, jnp.asarray(tok), j_cache)
        with torch.no_grad():
            logits, cache = model.decode_step(torch.from_numpy(tok).long(), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=1e-4, atol=1e-5,
                                   err_msg=f"decode step at {t}")


# ------------------------------------------------------- registry and knobs
def test_registry_resolves_gpt2_moe_on_the_dense_preset():
    from deepspeed_tpu.models.registry import resolve_family as jresolve

    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.models.registry import resolve_family

    cls, presets = resolve_family("gpt2-moe-125m")
    assert presets == {"gpt2-moe-125m": gpt2.PRESETS["gpt2-125m"]}
    model = cls(dataclasses.replace(presets["gpt2-moe-125m"], n_layer=2))
    assert isinstance(model, tmoe.MoEGPT2) and model.num_experts == 8 and model.ep_size == 1
    jcls, _, jpresets = jresolve("gpt2-moe-125m")
    assert jcls.keywords == {"num_experts": 8, "ep_size": 1}
    assert resolve_family("gpt2-moe-tiny", moe_experts=4)[0].keywords["num_experts"] == 4
    with pytest.raises(KeyError):
        resolve_family("gpt2-moe-9b")


def test_later_knobs_raise(tmp_path):
    from deepspeed_tpu_torch.runtime import zero

    params = _jax_params(seed=11)
    # ZeRO-Infinity of a MoE model still raises (its layerwise engine would
    # walk only the dense blocks); optimizer and param offload and zero.Init
    # take the expert banks as units (test_torch_gpt2_moe_offload.py,
    # test_torch_gpt2_moe_zero_init.py)
    with pytest.raises(NotImplementedError, match="MoE"):
        deepspeed_tpu_torch.initialize(
            model=_port(params),
            config=_config(3, offload_param={"device": "nvme", "nvme_path": str(tmp_path)}),
            device="cpu")
    for extra in ({"offload_optimizer": {"device": "cpu"}}, {"offload_param": {"device": "cpu"}}):
        engine, *_ = deepspeed_tpu_torch.initialize(model=_port(params),
                                                    config=_config(3, **extra), device="cpu")
        assert np.isfinite(float(engine.train_batch(_torch(_batch(ROWS * GAS, seed=11)))))
    with zero.Init(config=_config(3), device="cpu"):
        state = zero.materialize(tmoe.MoEGPT2(_tcfg(), num_experts=E), torch.Generator())
    assert any(state.fetched)
    with pytest.raises(ValueError, match="tpu.expert=1"):
        deepspeed_tpu_torch.initialize(model=tmoe.params_from_jax(
            params, _tcfg(), num_experts=E, ep_size=2), config=_config(0), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        deepspeed_tpu_torch.initialize(model=_port(params),
                                       config={**_config(0), "tpu": {"expert": 2}}, device="cpu")
    with pytest.raises(NotImplementedError, match="expert-parallel serving"):
        deepspeed_tpu_torch.init_inference(_port(params), config={"moe": {"ep_size": 2}},
                                           device="cpu")
    with pytest.raises(NotImplementedError, match="expert-parallel size"):
        deepspeed_tpu_torch.init_inference(
            tmoe.params_from_jax(params, _tcfg(), num_experts=E, ep_size=2), device="cpu")
    sparse = tmoe.MoEGPT2(_tcfg(sparse_attention={"mode": "fixed", "block": 16}))
    with pytest.raises(NotImplementedError, match="sparse_attention"):
        sparse.init_cache(1, 16)                  # trained sparse, not served (as in JAX)
    with pytest.raises(NotImplementedError, match="dropout"):
        tmoe.MoEGPT2(_tcfg(dropout=0.1))
    with pytest.raises(ValueError, match="even"):
        tmoe.MoEGPT2(_tcfg(n_layer=3))
