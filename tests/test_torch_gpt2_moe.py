"""The port's MoE GPT-2 against the JAX package's, on the CPU: the model.

``params_from_jax`` copies the JAX ``MoEGPT2`` params exactly (its ``moe``
subtree stacked over the MoE layers onto one module per layer; this rank's
experts at an expert-parallel size above 1), and the same numpy batch goes
into both. Logits, the loss (cross entropy plus ``aux_loss_coef`` times
the pairs' mean ``l_aux``) and every gradient are held to the JAX model
under ``jax.grad`` at top-1 and top-2, with and without drops and with a
``loss_mask``, in fp32 at ``test_torch_gpt2.py``'s tolerances (loss rtol
1e-5, gradients rtol 1e-4 / atol 2e-5); a skewed gate makes the queues
overflow. The odd blocks' MLP weights get no gradient (JAX's are zero).
The engine, its tags and serving: ``test_torch_gpt2_moe_engine.py``.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models import gpt2_moe as tmoe
from deepspeed_tpu_torch.models.gpt2 import GPT2Config

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
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, batch)))(params)
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
