"""The remat policies of the port against the JAX package and against remat off.

GPT-2 takes off, "full", "dots", "attn" and "attn_mlp"; llama and BERT off,
"full", "dots" and "attn" (their JAX configs have no "attn_mlp"). A policy
changes what the backward recomputes, never the values: the loss and every
gradient are held to the JAX model under the same policy (fp32 on the CPU,
loss rtol 1e-5, gradients within 1e-4 of each tensor's largest) and to the
port with remat off (the same arithmetic: rtol 1e-5). The flash forward's
entry is counted per loss and backward: under "attn" and "attn_mlp" it runs
once per layer (the policy keeps its outputs and the recompute reads them
back), under "full" and "dots" twice, and the backward once per layer under
every policy. GPT-2's cases are here, llama's and BERT's in
``test_torch_remat_llama_bert.py``. Two gloo ranks train a GPT-2 at ZeRO stage 3 under "attn"
against one rank at stage 0 without remat: the same losses, the weights of
the same ranks under "full" bit for bit, and the stage-3 units gathered
again in the recompute, as under "full".
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.ops.pallas import flash_attention as tfa
from tests.torch_world import World

GPT2 = dict(vocab_size=256, n_positions=32, n_embd=64, n_layer=2, n_head=2)
LLAMA = dict(vocab_size=256, n_positions=32, n_embd=64, n_layer=2, n_head=4, n_kv_head=2,
             intermediate_size=128)
BERT = dict(vocab_size=256, n_positions=32, n_embd=64, n_layer=2, n_head=2)
FAMILIES = {"gpt2": (False, "full", "dots", "attn", "attn_mlp"),
            "llama": (False, "full", "dots", "attn"),
            "bert": (False, "full", "dots", "attn")}
CASES = [(f, p) for f, policies in FAMILIES.items() for p in policies]
# this file holds GPT-2's cases; llama's and BERT's are in
# test_torch_remat_llama_bert.py, so the two files run side by side
GPT2_CASES = [c for c in CASES if c[0] == "gpt2"]
B, T, WORLD, STEPS = 4, 32, 2, 3


def _family(name):
    """(JAX config class, JAX model class, port module, port config class,
    port model class, widths)."""
    if name == "gpt2":
        from deepspeed_tpu.models import gpt2 as j
        return j.GPT2Config, j.GPT2Model, tgpt2, tgpt2.GPT2Config, tgpt2.GPT2Model, GPT2
    if name == "llama":
        from deepspeed_tpu.models import llama as j
        return j.LlamaConfig, j.LlamaModel, tllama, tllama.LlamaConfig, tllama.LlamaModel, LLAMA
    from deepspeed_tpu.models import bert as j
    return j.BertConfig, j.BertModel, tbert, tbert.BertConfig, tbert.BertModel, BERT


def _batch(name, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(4, 256, size=(B, T)).astype(np.int32)
    if name != "bert":
        return {"input_ids": ids}
    labels = np.where(rs.rand(B, T) < 0.2, ids, -100).astype(np.int32)
    return {"input_ids": np.where(labels >= 0, 0, ids).astype(np.int32), "labels": labels}


def _port(name, params, remat):
    _, _, tmod, tcfg, _, small = _family(name)
    return tmod.params_from_jax(params, tcfg(**small, remat=remat, dtype=torch.float32))


def _loss_and_grads(model, batch):
    loss = model.loss({k: torch.from_numpy(v).long() for k, v in batch.items()})
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


def _jax_ref(name, remat, seed):
    import jax

    import jax.numpy as jnp

    jcfg, jmodel_cls, _, _, _, small = _family(name)
    jmodel = jmodel_cls(jcfg(**small, dtype=jnp.float32, remat=remat))
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    batch = _batch(name, seed)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmodel.loss(p, batch)))(params)
    return params, batch, np.asarray(loss), grads


def _within(got, ref, rel, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, f"{what}: max err {err} over {rel} x {scale}"


def check_loss_and_grads(family, policy):
    """The loss and every gradient under ``policy``: the JAX model's under
    the same policy and the port's without remat."""
    params, batch, jloss, jgrads = _jax_ref(family, policy, seed=1)
    loss, grads = _loss_and_grads(_port(family, params, policy), batch)
    loss0, grads0 = _loss_and_grads(_port(family, params, False), batch)
    _within(loss, jloss, 1e-5, "loss")
    torch.testing.assert_close(loss, loss0, rtol=1e-5, atol=0)
    assert grads.keys() == grads0.keys()
    for n, g in grads.items():
        if n.startswith("blocks."):
            _, layer, key = n.split(".")
            ref = jgrads["blocks"][key][int(layer)]
        else:
            ref = jgrads[n]
        _within(g, ref, 1e-4, n)
        torch.testing.assert_close(g, grads0[n], rtol=1e-5, atol=1e-7, msg=n)


def check_flash_entry_calls(monkeypatch, family, policy):
    """The flash forward's entry (the kernel on the card, its plain version
    here) once per layer and step under "attn" / "attn_mlp" and without
    remat, twice under "full" / "dots"; the backward once per layer."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa.flash_forward, tfa.flash_backward

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(tfa, "flash_forward", count_fwd)
    monkeypatch.setattr(tfa, "flash_backward", count_bwd)
    _, _, _, tcfg, tmodel, small = _family(family)
    model = tmodel(tcfg(**small, remat=policy, dtype=torch.float32))
    model.init_params(torch.Generator().manual_seed(0))
    _loss_and_grads(model, _batch(family))
    layers = small["n_layer"]
    assert calls == {"fwd": layers * (2 if policy in ("full", "dots") else 1), "bwd": layers}


@pytest.mark.parametrize("family,policy", GPT2_CASES)
def test_loss_and_grads_match_jax_and_remat_off(family, policy):
    check_loss_and_grads(family, policy)


@pytest.mark.parametrize("family,policy", GPT2_CASES)
def test_flash_entry_calls_per_step(monkeypatch, family, policy):
    check_flash_entry_calls(monkeypatch, family, policy)


def test_policy_names_what_jax_names():
    """GPT-2 and its families carry all five settings; llama and BERT refuse
    "attn_mlp", as their JAX configs do."""
    assert "attn_mlp" in tgpt2.GPT2Config.VALID_REMAT
    for cls, small in ((tllama.LlamaConfig, LLAMA), (tbert.BertConfig, BERT)):
        with pytest.raises(ValueError):
            cls(**small, remat="attn_mlp")


# --------------------------------------------- two gloo ranks at stage 3
def _config(stage):
    return {"train_batch_size": B, "gradient_accumulation_steps": 1, "steps_per_print": 0,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 100}}


def _ranks(rank, world, out_dir, np_params, batch):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import flatten_state

    out = {}
    for remat in ("attn", "full"):
        model = tgpt2.params_from_jax(np_params, tgpt2.GPT2Config(**GPT2, remat=remat,
                                                                  dtype=torch.float32))
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=_config(3),
                                                    device="cpu")
        rows = {k: v[rank::world] for k, v in batch.items()}
        losses = [float(engine.train_batch(rows)) for _ in range(STEPS)]
        state = flatten_state(engine)
        out[remat] = {"losses": losses, "gathers": engine._zero.gathers,
                      "params": {k: v.numpy().copy() for k, v in state.items()
                                 if k.startswith("params/")}}
    return out


def test_two_ranks_at_stage3_under_attn_train_like_stage0(tmp_path):
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu_torch
    from deepspeed_tpu.models import gpt2 as jgpt2

    params = jax.tree.map(np.asarray, jgpt2.GPT2Model(jgpt2.GPT2Config(
        **GPT2, dtype=jnp.float32, remat=False)).init_params(jax.random.PRNGKey(3)))
    batch = _batch("gpt2", 3)
    world = World(_ranks, WORLD, str(tmp_path), args=(params, batch))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.params_from_jax(params, tgpt2.GPT2Config(**GPT2, remat=False,
                                                             dtype=torch.float32)),
        config=_config(0), device="cpu")
    ref = [float(engine.train_batch(batch)) for _ in range(STEPS)]
    ranks = world.join()
    for rank, got in enumerate(ranks):
        attn, full = got["attn"], got["full"]
        np.testing.assert_allclose(attn["losses"], ref, rtol=1e-5, err_msg=f"rank {rank}")
        # the same arithmetic as "full" on the same ranks: the weights equal
        # bit for bit (stage 0's differ in summation order, which AdamW
        # amplifies on the near-zero gradients of the key biases)
        assert attn["params"].keys() == full["params"].keys()
        for k, v in full["params"].items():
            np.testing.assert_array_equal(attn["params"][k], v, err_msg=f"rank {rank} {k}")
        # the recompute gathers each block's unit again: as many as "full"
        assert attn["gathers"] == full["gathers"] > 0
