"""The port's GPT-2 training path against the JAX package.

The JAX package's ``init_params`` draws the weights; ``params_from_jax``
copies them exactly into the port's ``GPT2Model``, and the same numpy token
batch goes into both. The loss and every gradient of ``GPT2Model.loss`` are
compared with JAX ``GPT2Model.loss`` and ``jax.grad``. Both sides compute in
fp32 on the CPU (JAX through its einsum attention, the port through the
flash ``autograd.Function``'s plain versions) and differ only in summation
order: loss rtol 1e-5, gradients atol 2e-5 on entries of order 1e-2 or less.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.models.common as jcommon
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import common as tcommon
from deepspeed_tpu_torch.models import gpt2 as tgpt2

SMALL = dict(vocab_size=512, n_positions=64, n_embd=128, n_layer=2, n_head=2)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)


def _configs(**over):
    kw = {**SMALL, **over}
    return (jgpt2.GPT2Config(**kw, dtype=jnp.float32),
            tgpt2.GPT2Config(**kw, dtype=torch.float32))


def _jax_params(cfg, seed=0):
    params = jgpt2.GPT2Model(cfg).init_params(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


def _batch(B=2, T=64, vocab=512, seed=0, mask=False):
    rs = np.random.RandomState(seed)
    batch = {"input_ids": rs.randint(0, vocab, size=(B, T)).astype(np.int32)}
    if mask:
        batch["loss_mask"] = (rs.rand(B, T) > 0.3).astype(np.float32)
    return batch


def _torch_loss_and_grads(model, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = model.loss(tb)
    loss.backward()
    return loss.detach().numpy(), {k: p.grad.numpy() for k, p in model.named_parameters()}


def _assert_grads_match(tgrads, jgrads):
    for name, g in tgrads.items():
        if name.startswith("blocks."):
            _, n, key = name.split(".")
            ref = jgrads["blocks"][key][int(n)]
        else:
            ref = jgrads[name]
        np.testing.assert_allclose(g, np.asarray(ref), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("mask", [False, True])
def test_loss_and_grads_match_jax(mask):
    jcfg, tcfg = _configs(remat=False)
    params = _jax_params(jcfg)
    batch = _batch(mask=mask)
    jmodel = jgpt2.GPT2Model(jcfg)
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.loss(p, batch))(params)
    tloss, tgrads = _torch_loss_and_grads(tgpt2.params_from_jax(params, tcfg), batch)
    np.testing.assert_allclose(tloss, np.asarray(jloss), **LOSS_TOL)
    assert len(tgrads) == len(tgpt2.BLOCK_KEYS) * tcfg.n_layer + len(jgrads) - 1
    _assert_grads_match(tgrads, jgrads)


def test_logits_match_jax():
    jcfg, tcfg = _configs(remat=False)
    params = _jax_params(jcfg, seed=1)
    ids = _batch(seed=1)["input_ids"]
    ref = jgpt2.GPT2Model(jcfg).apply(params, jnp.asarray(ids))
    with torch.no_grad():
        got = tgpt2.params_from_jax(params, tcfg).apply(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_remat_full_matches_no_remat():
    """``remat=True`` recomputes each block under torch.utils.checkpoint;
    the recomputation is the same arithmetic, so the grads agree."""
    jcfg, tcfg = _configs(remat=False)
    params = _jax_params(jcfg, seed=2)
    batch = _batch(seed=2)
    loss0, grads0 = _torch_loss_and_grads(tgpt2.params_from_jax(params, tcfg), batch)
    loss1, grads1 = _torch_loss_and_grads(
        tgpt2.params_from_jax(params, dataclasses.replace(tcfg, remat=True)), batch)
    np.testing.assert_allclose(loss1, loss0, rtol=1e-6)
    for name in grads0:
        np.testing.assert_allclose(grads1[name], grads0[name], rtol=1e-5, atol=1e-7,
                                   err_msg=name)


def test_chunked_lm_loss_matches_jax_with_mask(monkeypatch):
    """Several chunks (the chunk budget shrunk in both packages) and a loss
    mask: value and gradients in x, head and bias."""
    monkeypatch.setattr(jcommon, "_CHUNK_ELEMS", 2 * 96 * 24)
    monkeypatch.setattr(tcommon, "_CHUNK_ELEMS", 2 * 96 * 24)
    rs = np.random.RandomState(3)
    B, T, D, V = 2, 48, 32, 96
    x = rs.standard_normal((B, T, D)).astype(np.float32)
    head = (0.2 * rs.standard_normal((D, V))).astype(np.float32)
    bias = (0.1 * rs.standard_normal(V)).astype(np.float32)
    tgt = rs.randint(0, V, size=(B, T)).astype(np.int32)
    mask = (rs.rand(B, T) > 0.5).astype(np.float32)

    def jloss(x, head, bias):
        return jcommon.chunked_lm_loss(x, head, jnp.asarray(tgt), jnp.asarray(mask), bias=bias)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(x, head, bias)
    tx, th, tb = (torch.tensor(a, requires_grad=True) for a in (x, head, bias))
    tl = tcommon.chunked_lm_loss(tx, th, torch.from_numpy(tgt), torch.from_numpy(mask), bias=tb)
    tl.backward()
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **LOSS_TOL)
    for name, g, r in zip(("x", "head", "bias"), (tx.grad, th.grad, tb.grad), jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **GRAD_TOL)


def test_params_from_jax_is_exact_and_counts_match():
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg, seed=4)
    model = tgpt2.params_from_jax(params, tcfg)
    np.testing.assert_array_equal(model.blocks[1].qkv_w.detach().numpy(),
                                  params["blocks"]["qkv_w"][1])
    n = sum(p.numel() for p in model.parameters())
    assert n == tcfg.num_params() == jcfg.num_params()
    assert tcfg.flops_per_token(64) == jcfg.flops_per_token(64)
    assert all(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("over", [dict(alibi=True), dict(rotary_pct=0.5),
                                  dict(parallel_residual=True), dict(remat="dots"),
                                  dict(sequence_parallel="ring"), dict(dropout=0.1)])
def test_variants_of_later_slices_raise(over):
    with pytest.raises(NotImplementedError):
        tgpt2.GPT2Config(**SMALL, **over)


# ------------------------------------------------------ block-sparse attention
SPARSE = {"mode": "fixed", "block": 16, "num_local_blocks": 2, "num_global_blocks": 1}


@pytest.mark.parametrize("block,remat", [
    (SPARSE, False),
    ({"mode": "bslongformer", "block": 16, "num_sliding_window_blocks": 1,
      "global_block_indices": [1]}, True)])
def test_sparse_loss_and_grads_match_jax(block, remat):
    """The same weights (``params_from_jax``: a sparse model has the dense
    model's params) through the JAX model's sparse attention (its dense
    token-level oracle off the TPU) and the port's (the sparse kernels'
    plain versions on the CPU)."""
    jcfg, tcfg = _configs(remat=remat, sparse_attention=block)
    params = _jax_params(jcfg, seed=5)
    batch = _batch(seed=5)
    jmodel = jgpt2.GPT2Model(jcfg)
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.loss(p, batch))(params)
    tmodel = tgpt2.params_from_jax(params, tcfg)
    tloss, tgrads = _torch_loss_and_grads(tmodel, batch)
    np.testing.assert_allclose(tloss, np.asarray(jloss), **LOSS_TOL)
    _assert_grads_match(tgrads, jgrads)
    dense_loss, _ = _torch_loss_and_grads(
        tgpt2.params_from_jax(params, dataclasses.replace(tcfg, sparse_attention=None)), batch)
    assert abs(float(dense_loss) - float(tloss)) > 1e-4      # the layout did something


def test_sparse_model_masks_distant_tokens():
    """A local-window-only layout hides far keys: changing a token outside
    every window of the last query leaves its logits unchanged in both
    packages; under dense attention it changes them."""
    over = dict(vocab_size=64, n_embd=32, n_layer=1, remat=False,
                sparse_attention={"mode": "fixed", "block": 16, "num_local_blocks": 1,
                                  "num_global_blocks": 0})
    jcfg, tcfg = _configs(**over)
    params = _jax_params(jcfg, seed=1)
    ids = np.random.RandomState(1).randint(0, 64, size=(1, 64)).astype(np.int32)
    far = ids.copy()
    far[0, 20] = (far[0, 20] + 1) % 64        # block 1: outside query block 3's window
    last = {}
    with torch.no_grad():
        for name, cfg in (("sparse", tcfg), ("dense", dataclasses.replace(tcfg,
                                                                          sparse_attention=None))):
            model = tgpt2.params_from_jax(params, cfg)
            last[name] = [model.apply(torch.from_numpy(x))[0, -1].numpy() for x in (ids, far)]
    np.testing.assert_array_equal(*last["sparse"])
    assert np.abs(last["dense"][0] - last["dense"][1]).max() > 0
    jmodel = jgpt2.GPT2Model(jcfg)
    ref = [np.asarray(jmodel.apply(params, jnp.asarray(x)))[0, -1] for x in (ids, far)]
    np.testing.assert_array_equal(*ref)
    np.testing.assert_allclose(last["sparse"][0], ref[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("over,exc", [
    (dict(sparse_attention={"mode": "strided"}), ValueError),
    (dict(sparse_attention={"mode": "fixed"}, alibi=True), NotImplementedError),
    (dict(sparse_attention={"mode": "fixed"}, sequence_parallel="ring"), NotImplementedError),
    (dict(sparse_attention={"mode": "fixed"}, attention_layers=("local", "global")),
     NotImplementedError)])
def test_sparse_config_conflicts_raise_like_jax(over, exc):
    with pytest.raises(exc):
        jgpt2.GPT2Config(**{**SMALL, **over})
    with pytest.raises(exc):
        tgpt2.GPT2Config(**{**SMALL, **over})


def test_sparse_block_of_another_mode_raises_like_jax():
    """The block's keys are the mode's keyword arguments, in both packages."""
    over = dict(remat=False, sparse_attention={"mode": "fixed", "block": 16,
                                                "num_random_blocks": 1})
    jcfg, tcfg = _configs(**over)
    params = _jax_params(jcfg)
    ids = _batch()["input_ids"]
    with pytest.raises(TypeError):
        jgpt2.GPT2Model(jcfg).apply(params, jnp.asarray(ids))
    with pytest.raises(TypeError):
        tgpt2.params_from_jax(params, tcfg).apply(torch.from_numpy(ids))


def test_registry_resolves_gpt2_presets():
    from deepspeed_tpu_torch.models.registry import resolve_family

    cls, presets = resolve_family("gpt2-760m")
    assert cls is tgpt2.GPT2Model
    c, j = presets["gpt2-760m"], jgpt2.PRESETS["gpt2-760m"]
    assert (c.n_embd, c.n_layer, c.n_head, c.head_dim) == (1536, 24, 16, 96)
    assert c.num_params() == j.num_params()
