"""Dropout and progressive layer drop in the port, against the JAX package.

JAX and torch draw different random masks, so the port is held to JAX where
no mask is drawn: dropout p > 0 without a generator (JAX without an rng)
and PLD with every gate kept (θ = 1). With a generator the port is held to
itself: the same seed gives the same masks with remat on and off (each
mask comes from a generator seeded inside its block, so the recompute
draws it again), the kept share of a mask is within 3σ of 1 - p, and a
kept element is scaled by 1 / (1 - p). The PLD schedule θ(t) and the
per-layer keep probabilities equal JAX's (fp32, 1e-6), a gate is 0 or
1 / p_l, and the engine hands the loss θ(t) of each step and refuses a
loss without ``pld_theta``. fp32 on the CPU: logits and loss within 1e-5,
gradients within 1e-4 (against JAX) or 1e-5 (port against port).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime import progressive_layer_drop as jpld
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models import common as tcommon
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.runtime import progressive_layer_drop as tpld

SMALL = dict(vocab_size=256, n_positions=32, n_embd=64, n_layer=4, n_head=2)
B, T = 4, 32


def _pair(dropout=0.1, **over):
    kw = {**SMALL, "dropout": dropout, "remat": False, **over}
    jcfg = jgpt2.GPT2Config(**kw, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jgpt2.GPT2Model(jcfg).init_params(jax.random.PRNGKey(0)))
    return jcfg, params


def _port(params, **over):
    kw = {**SMALL, "dropout": 0.1, "remat": False, **over}
    return tgpt2.params_from_jax(params, tgpt2.GPT2Config(**kw, dtype=torch.float32))


def _ids(seed=0):
    return np.random.RandomState(seed).randint(0, 256, (B, T)).astype(np.int32)


def _grads(model, ids, **kw):
    model.zero_grad(set_to_none=True)
    loss = model.loss({"input_ids": torch.from_numpy(ids)}, **kw)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def _within(got, ref, rel, what=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, f"{what}: max err {err} over {rel} x {scale}"


def test_dropout_without_a_generator_equals_jax():
    jcfg, params = _pair()
    ids = _ids(1)
    jmodel = jgpt2.GPT2Model(jcfg)
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.loss(p, {"input_ids": ids}))(params)
    model = _port(params)
    with torch.no_grad():
        _within(model.apply(torch.from_numpy(ids)), jmodel.apply(params, jnp.asarray(ids)), 1e-5)
    loss, grads = _grads(model, ids)
    _within(loss, jloss, 1e-5, "loss")
    for n, g in grads.items():
        ref = jgrads["blocks"][n.split(".")[2]][int(n.split(".")[1])] \
            if n.startswith("blocks.") else jgrads[n]
        _within(g, ref, 1e-4, n)


def test_zero_dropout_with_a_generator_equals_jax_with_an_rng():
    jcfg, params = _pair(dropout=0.0)
    ids = _ids(2)
    jloss = jgpt2.GPT2Model(jcfg).loss(params, {"input_ids": ids}, rng=jax.random.PRNGKey(5))
    loss, _ = _grads(_port(params, dropout=0.0), ids, generator=torch.Generator().manual_seed(5))
    _within(loss, jloss, 1e-5, "loss")


@pytest.mark.parametrize("remat", ["full", "dots", "attn", "attn_mlp"])
def test_dropout_under_remat_equals_remat_off_on_the_same_seed(remat):
    """The same generator seed: the same masks in the forward and in the
    recompute, so the loss and gradients equal remat off's; another seed
    gives another loss."""
    _, params = _pair()
    ids = _ids(3)
    gen = lambda s=7: torch.Generator().manual_seed(s)
    loss0, grads0 = _grads(_port(params), ids, generator=gen())
    loss1, grads1 = _grads(_port(params, remat=remat), ids, generator=gen())
    torch.testing.assert_close(loss1, loss0, rtol=1e-6, atol=0)
    for n in grads0:
        torch.testing.assert_close(grads1[n], grads0[n], rtol=1e-5, atol=1e-7, msg=n)
    other, _ = _grads(_port(params), ids, generator=gen(8))
    plain, _ = _grads(_port(params), ids)
    assert len({float(loss0), float(other), float(plain)}) == 3


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_kept_share_is_within_three_sigma(p):
    n = 1 << 18
    x = torch.ones(n)
    out = tcommon.dropout(x, p, seed=11)
    kept = out != 0
    share = kept.float().mean().item()
    assert abs(share - (1 - p)) <= 3 * math.sqrt(p * (1 - p) / n), share
    assert torch.all(out[kept] == torch.tensor(1 / (1 - p)))
    assert torch.equal(tcommon.dropout(x, p, seed=11), out)
    assert not torch.equal(tcommon.dropout(x, p, seed=12), out)
    assert tcommon.dropout(x, p, None) is x and tcommon.dropout(x, 0.0, 3) is x


def test_theta_schedule_and_keep_probs_equal_jax():
    for theta in (0.5, 0.9, 1.0):
        for gamma in (0.0, 0.001, 0.05):
            for step in (0, 1, 10, 1000, 20000):
                np.testing.assert_allclose(tpld.theta_at(step, theta, gamma),
                                           float(jpld.theta_at(step, theta, gamma)),
                                           rtol=1e-6)
        for n_layer in (1, 4, 24):
            np.testing.assert_allclose(tpld.layer_keep_probs(theta, n_layer).numpy(),
                                       np.asarray(jpld.layer_keep_probs(theta, n_layer)),
                                       rtol=1e-6)
    ref = jpld.ProgressiveLayerDrop.__new__(jpld.ProgressiveLayerDrop)
    ref.theta, ref.gamma = 0.5, 0.01
    ours = tpld.ProgressiveLayerDrop(theta=0.5, gamma=0.01)
    for step in (1, 50):
        ref.update_state(step)
        ours.update_state(step)
        assert ours.get_theta() == tpld.theta_at(step, 0.5, 0.01)
        np.testing.assert_allclose(ours.get_theta(), ref.get_theta(), rtol=1e-6)
    assert ours.get_state() == {"progressive_layer_drop": True, "pld_theta": ours.get_theta()}


def test_gates_are_zero_or_the_inverse_keep_probability():
    keep = tpld.layer_keep_probs(0.5, 8)
    gen = torch.Generator().manual_seed(0)
    seen = torch.stack([tcommon.pld_gates(0.5, 8, gen) for _ in range(200)])
    for l in range(8):
        vals = set(seen[:, l].tolist())
        assert vals <= {0.0, float(1.0 / keep[l])}, vals
    share = (seen > 0).float().mean(dim=0)
    assert torch.all((share - keep).abs() <= 3 * torch.sqrt(keep * (1 - keep) / 200) + 1e-6)


def test_every_gate_kept_equals_pld_off_and_jax():
    """θ = 1 keeps every block with gate 1: GPT-2's and BERT's losses equal
    PLD off's and JAX's at θ = 1."""
    jcfg, params = _pair(dropout=0.0)
    ids = _ids(4)
    gen = lambda: torch.Generator().manual_seed(3)
    model = _port(params, dropout=0.0)
    off, goff = _grads(model, ids)
    kept, gkept = _grads(model, ids, generator=gen(), pld_theta=1.0)
    jl = jgpt2.GPT2Model(jcfg).loss(params, {"input_ids": ids}, rng=jax.random.PRNGKey(1),
                                    pld_theta=jnp.float32(1.0))
    torch.testing.assert_close(kept, off, rtol=1e-6, atol=0)
    _within(kept, jl, 1e-5, "gpt2 vs jax")
    for n in goff:
        torch.testing.assert_close(gkept[n], goff[n], rtol=1e-5, atol=1e-7, msg=n)
    # some layers dropped at θ = 0.5: another loss
    dropped, _ = _grads(model, ids, generator=gen(), pld_theta=0.2)
    assert torch.isfinite(dropped) and float(dropped) != float(off)

    bk = dict(vocab_size=256, n_positions=32, n_embd=64, n_layer=3, n_head=2)
    jb = jbert.BertConfig(**bk, dtype=jnp.float32)
    bparams = jax.tree.map(np.asarray, jbert.BertModel(jb).init_params(jax.random.PRNGKey(2)))
    batch = tbert.synthetic_mlm_batch(B, T, 256, seed=5)
    jloss = jbert.BertModel(jb).loss(bparams, {k: v.numpy() for k, v in batch.items()},
                                     rng=jax.random.PRNGKey(1), pld_theta=jnp.float32(1.0))
    bmodel = tbert.params_from_jax(bparams, tbert.BertConfig(**bk, dtype=torch.float32))
    b_off = bmodel.loss(batch)
    b_kept = bmodel.loss(batch, pld_theta=1.0, generator=gen())
    torch.testing.assert_close(b_kept, b_off, rtol=1e-6, atol=0)
    _within(b_kept.detach(), jloss, 1e-5, "bert vs jax")


class _Recording(tgpt2.GPT2Model):
    """GPT-2 whose loss records the θ it is handed."""

    def __init__(self, config):
        super().__init__(config)
        self.seen = []

    def loss(self, batch, generator=None, pld_theta=None):
        self.seen.append(pld_theta)
        return super().loss(batch, generator, pld_theta)


def _config(pld):
    return {"train_batch_size": B, "steps_per_print": 0,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "progressive_layer_drop": pld}


def test_engine_passes_theta_of_each_step():
    pld = {"enabled": True, "theta": 0.5, "gamma": 0.1}
    model = _Recording(tgpt2.GPT2Config(**SMALL, remat=False, dtype=torch.float32))
    model.init_params(torch.Generator().manual_seed(0))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=_config(pld), device="cpu")
    batch = {"input_ids": _ids(6)}
    losses = [float(engine.train_batch(batch)) for _ in range(3)]
    assert all(math.isfinite(x) for x in losses)
    assert model.seen == [tpld.theta_at(s, 0.5, 0.1) for s in range(3)]
    assert engine.progressive_layer_drop.get_theta() == tpld.theta_at(3, 0.5, 0.1)
    # disabled: no θ; a loss without pld_theta is refused, as in JAX
    model = _Recording(tgpt2.GPT2Config(**SMALL, remat=False, dtype=torch.float32))
    model.init_params(torch.Generator().manual_seed(0))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=_config({"enabled": False}),
                                                device="cpu")
    engine.train_batch(batch)
    assert model.seen == [None] and engine.progressive_layer_drop is None
    llama = tllama.LlamaModel(tllama.PRESETS["llama-tiny"])
    with pytest.raises(ValueError, match="pld_theta"):
        deepspeed_tpu_torch.initialize(model=llama, config=_config(pld), device="cpu")
    with pytest.raises(ValueError, match="theta"):
        deepspeed_tpu_torch.initialize(model=model, config=_config({"enabled": True,
                                                                    "theta": 0.0}),
                                       device="cpu")
