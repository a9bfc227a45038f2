"""The port's MoE GPT-2 against the JAX package's, on the CPU.

``params_from_jax`` copies the JAX ``MoEGPT2`` params exactly (its ``moe``
subtree stacked over the MoE layers onto one module per layer; this rank's
experts at an expert-parallel size above 1), and the same numpy batch goes
into both. Logits, the loss (cross entropy plus ``aux_loss_coef`` times
the pairs' mean ``l_aux``) and every gradient are held to the JAX model
under ``jax.grad`` at top-1 and top-2, with and without drops and with a
``loss_mask``, in fp32 at ``test_torch_gpt2.py``'s tolerances (loss rtol
1e-5, gradients rtol 1e-4 / atol 2e-5); a skewed gate makes the queues
overflow. The odd blocks' MLP weights get no gradient (JAX's are zero).
``initialize`` trains the model as the JAX engine does at ZeRO stages 0-3
(3 AdamW steps, gas 2, a loss mask; its weight decay moving the unused
weights alike), at 1e-4. Prefill and decode walk the pairs: without drops
they equal the full forward, and with drops they equal JAX's ``prefill``
and ``decode_step`` logits. The registry resolves ``gpt2-moe-*``; a
trained tag serves bit for bit; a JAX MoE tag continues in the port
through ``state_from_jax``; the knobs of later slices raise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2_moe as tmoe
from deepspeed_tpu_torch.models.gpt2 import GPT2Config
from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (apply_flat_state,
                                                                   flatten_state, state_from_jax,
                                                                   wait_for_pending_saves)

TINY = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=4, n_head=4, remat=False)
E, SEQ, STEPS, GAS, ROWS = 4, 16, 3, 2, 8
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
# (top-k, capacity factor, drop_tokens, loss mask): 1.0 with the skewed
# gate drops tokens, 4.0 none
CASES = {"k1_drops": (1, 1.0, True, False), "k1_no_drops": (1, 1.0, False, False),
         "k1_drops_mask": (1, 1.0, True, True), "k2_drops": (2, 1.0, True, False),
         "k2_roomy_mask": (2, 4.0, True, True)}


def _tcfg(**over):
    return GPT2Config(**{**TINY, **over}, dtype=torch.float32)


def _jax_model(k=1, cf=1.0, drop=True, **over):
    import jax.numpy as jnp

    from deepspeed_tpu.models.gpt2 import GPT2Config as JConfig
    from deepspeed_tpu.models.gpt2_moe import MoEGPT2

    return MoEGPT2(JConfig(**{**TINY, **over}, dtype=jnp.float32), num_experts=E, k=k,
                   capacity_factor=cf, drop_tokens=drop)


def _jax_params(seed=0, skew=1.0):
    import jax

    params = jax.tree.map(np.asarray, _jax_model().init_params(jax.random.PRNGKey(seed)))
    params["moe"]["gate"]["wg"] = params["moe"]["gate"]["wg"] + np.array(
        [skew] + [0.0] * (E - 1), np.float32)
    return params


def _batch(rows, seed=0, mask=False):
    rs = np.random.RandomState(seed)
    batch = {"input_ids": rs.randint(0, TINY["vocab_size"], size=(rows, SEQ)).astype(np.int32)}
    if mask:
        keep = np.where(np.arange(rows)[:, None] % 2 == 0, 0.9, 0.3)
        batch["loss_mask"] = (rs.rand(rows, SEQ) < keep).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_leaf(tree, name):
    parts = name.split(".")
    if parts[0] == "blocks":
        return np.asarray(tree["blocks"][parts[2]][int(parts[1])])
    if parts[0] == "moe":
        leaf = tree["moe"]
        for key in parts[2:]:
            leaf = leaf[key]
        return np.asarray(leaf[int(parts[1])])
    return np.asarray(tree[name])


def _port(params, k=1, cf=1.0, drop=True, **over):
    return tmoe.params_from_jax(params, _tcfg(**over), num_experts=E, k=k, capacity_factor=cf,
                                drop_tokens=drop)


# ------------------------------------------------------------ params, logits
def test_params_from_jax_is_exact():
    params = _jax_params()
    model = _port(params)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == 4 + 12 * TINY["n_layer"] + 5 * (TINY["n_layer"] // 2)
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), _jax_leaf(params, name), err_msg=name)
    half = tmoe.params_from_jax(params, _tcfg(), num_experts=E, ep_size=2, ep_rank=1)
    np.testing.assert_array_equal(half.moe[1].experts.wo.detach().numpy(),
                                  params["moe"]["experts"]["wo"][1][2:])
    assert half.expert_module_names() == ["moe.0.experts", "moe.1.experts"]


def test_apply_and_hidden_states_match_jax():
    import jax.numpy as jnp

    params = _jax_params(seed=1)
    ids = _batch(3, seed=1)["input_ids"]
    model = _port(params)
    with torch.no_grad():
        logits = model.apply(torch.from_numpy(ids).long())
        hidden = model.hidden_states(torch.from_numpy(ids).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(_jax_model().apply(params, ids)),
                               rtol=1e-4, atol=1e-5)
    x, _ = _jax_model()._moe_trunk(params, jnp.asarray(ids))
    np.testing.assert_allclose(hidden.numpy(), np.asarray(x), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_gradient_match_jax(case):
    import jax

    k, cf, drop, mask = CASES[case]
    params = _jax_params(seed=2)
    batch = _batch(4, seed=2, mask=mask)
    jm = _jax_model(k, cf, drop)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, batch))(params)
    model = _port(params, k, cf, drop)
    loss = model.loss(_torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    for name, p in model.named_parameters():
        want = _jax_leaf(jgrads, name)
        if p.grad is None:
            # the odd blocks' dense MLP: unused, as in JAX
            assert name.startswith(("blocks.1.fc", "blocks.3.fc")), name
            assert not want.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want, err_msg=name, **GRAD_TOL)


def test_the_skewed_gate_drops_tokens():
    params = _jax_params(seed=2)
    model = _port(params)
    for layer in model.moe:
        layer.moe_layer.record = True
    with torch.no_grad():
        model.loss(_torch(_batch(4, seed=2)))
    w = model.moe[0].moe_layer.routing["weights"]
    assert (w == 0).sum() > 0


def test_remat_per_pair_equals_no_remat():
    params = _jax_params(seed=3)
    batch = _torch(_batch(4, seed=3, mask=True))
    out = {}
    for remat in (False, "full"):
        model = _port(params, k=2, remat=remat)
        g = torch.Generator().manual_seed(0)
        loss = model.loss(batch, generator=g)
        loss.backward()
        out[remat] = (loss.item(), {n: p.grad for n, p in model.named_parameters()
                                    if p.grad is not None})
    assert out["full"][0] == pytest.approx(out[False][0], rel=1e-6)
    for name, g in out[False][1].items():
        torch.testing.assert_close(out["full"][1][name], g, rtol=1e-5, atol=1e-7, msg=name)


def test_loss_weight_divides_only_the_aux_term():
    params = _jax_params(seed=4)
    batch = _torch(_batch(2, seed=4))
    model = _port(params)
    with torch.no_grad():
        full = model.loss(batch)
        halved = model.loss(batch, loss_weight=torch.tensor(2.0))
        model.aux_loss_coef = 0.0
        ce = model.loss(batch)
    torch.testing.assert_close(halved, ce + (full - ce) / 2)


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
    import jax.numpy as jnp

    params = _jax_params(seed=10, skew=2.0)
    jm, model = _jax_model(), _port(params)
    ids = _batch(4, seed=10)["input_ids"]
    j_logits, j_cache = jm.prefill(params, jnp.asarray(ids[:, :12]), jm.init_cache(4, SEQ))
    with torch.no_grad():
        logits, cache = model.prefill(torch.from_numpy(ids[:, :12]).long(),
                                      model.init_cache(4, SEQ))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=1e-4, atol=1e-5)
    for t in range(12, SEQ):
        tok = ids[:, t]
        j_logits, j_cache = jm.decode_step(params, jnp.asarray(tok), j_cache)
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
    for extra in ({"offload_optimizer": {"device": "cpu"}},
                  {"offload_param": {"device": "cpu"}},
                  {"offload_param": {"device": "nvme", "nvme_path": str(tmp_path)}}):
        with pytest.raises(NotImplementedError, match="MoE"):
            deepspeed_tpu_torch.initialize(model=_port(params), config=_config(3, **extra),
                                           device="cpu")
    with pytest.raises(NotImplementedError, match="zero.Init of a MoE model"):
        with zero.Init(config=_config(3), device="cpu"):
            zero.materialize(tmoe.MoEGPT2(_tcfg(), num_experts=E), torch.Generator())
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
    with pytest.raises(NotImplementedError, match="sparse_attention"):
        tmoe.MoEGPT2(_tcfg(sparse_attention={"mode": "fixed", "block": 16}))
    with pytest.raises(ValueError, match="even"):
        tmoe.MoEGPT2(_tcfg(n_layer=3))
