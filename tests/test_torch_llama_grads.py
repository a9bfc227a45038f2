"""The port's llama model against the JAX package, on the CPU: the loss and
every gradient, the trunk and the random draws, and ``zero.Init`` with both
offloads (the engine against the JAX engine: ``test_torch_llama_train.py``,
whose helpers these tests share).

The JAX package's ``init_params`` draws the weights; ``params_from_jax``
copies them exactly into the port's ``LlamaModel``, and the same numpy
token batch goes into both. The loss and every gradient of
``LlamaModel.loss`` are held to JAX ``LlamaModel.loss`` under ``jax.grad``
with a separate and a tied head, grouped KV heads repeated 2 and 4 times
(each KV head's gradient the sum over its group of query heads, as
``jnp.repeat``'s transpose), llama3 rope scaling and a ``loss_mask``. Both
sides compute in fp32 (JAX through its einsum attention, the port through
the flash ``autograd.Function``'s plain versions) and differ only in
summation order: loss rtol 1e-5, gradients rtol 1e-4 / atol 2e-5, the
tolerances of ``test_torch_gpt2.py``. One process with the weights built
by ``zero.Init`` at stage 3 and both offloads on trains as the whole-tree
weights of the same seed at stage 0.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import llama as tllama
from tests.test_torch_llama_train import (CASES, GAS, GRAD_TOL, LOSS_TOL, STEPS, _batch,
                                          _config, _jax_leaf, _jax_params, _jcfg, _params_of,
                                          _tcfg, _torch)


# --------------------------------------------------------- loss and grads
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(case):
    import jax

    from deepspeed_tpu.models import llama as jllama

    over = dict(CASES[case])
    mask = over.pop("mask")
    jcfg, tcfg = _jcfg(**over), _tcfg(**over)
    params = _jax_params(jcfg)
    batch = _batch(4, seed=1, mask=mask)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jllama.LlamaModel(jcfg).loss(p, batch)))(params)
    model = tllama.params_from_jax(params, tcfg)
    loss = model.loss(_torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss), **LOSS_TOL)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(tllama.BLOCK_KEYS) * tcfg.n_layer + (2 if tcfg.tie_embeddings else 3)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(_jax_leaf(jgrads, name)),
                                   err_msg=name, **GRAD_TOL)


def test_remat_full_matches_no_remat():
    """``remat`` recomputes each block under torch.utils.checkpoint: the
    same arithmetic, so the same loss and gradients."""
    params = _jax_params(_jcfg(), seed=2)
    batch = _torch(_batch(4, seed=2))
    out = {}
    for remat in (False, "full"):
        model = tllama.params_from_jax(params, _tcfg(remat=remat))
        loss = model.loss(batch)
        loss.backward()
        out[remat] = (loss.item(), {n: p.grad for n, p in model.named_parameters()})
    assert out["full"][0] == pytest.approx(out[False][0], rel=1e-6)
    for name, g in out[False][1].items():
        torch.testing.assert_close(out["full"][1][name], g, rtol=1e-5, atol=1e-7, msg=name)


def test_hidden_states_and_logits_match_jax():
    import jax.numpy as jnp

    from deepspeed_tpu.models import llama as jllama

    jcfg, tcfg = _jcfg(tie_embeddings=True), _tcfg(tie_embeddings=True)
    params = _jax_params(jcfg, seed=3)
    ids = _batch(2, seed=3)["input_ids"]
    jm = jllama.LlamaModel(jcfg)
    with torch.no_grad():
        model = tllama.params_from_jax(params, tcfg)
        hidden = model.hidden_states(torch.from_numpy(ids))
        logits = model.apply(torch.from_numpy(ids))
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jm.hidden_states(params, jnp.asarray(ids))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jm.apply(params, jnp.asarray(ids))),
                               rtol=1e-4, atol=1e-4)


def test_loss_tokens_count_the_masked_targets():
    model = tllama.LlamaModel(_tcfg())
    batch = _torch(_batch(4, mask=True))
    assert model.loss_tokens(batch).item() == batch["loss_mask"][:, 1:].sum().item()
    assert model.loss_tokens({"input_ids": batch["input_ids"]}) is None


# ------------------------------------------------------------------ params
@pytest.mark.parametrize("tied", [False, True])
def test_param_chunks_assemble_into_init_params(tied):
    """Pieces of a few hundred elements cover every parameter once, in
    order, and assemble into ``init_params``'s names and shapes; the values
    follow the JAX distribution: normal 0.02, ``o_w`` and ``down_w``
    0.02/sqrt(2L), unit norm gains."""
    cfg = _tcfg(tie_embeddings=tied, n_embd=128, intermediate_size=256)
    model = tllama.LlamaModel(cfg)
    shapes = {n: p.shape for n, p in model.named_parameters()}
    whole = tllama.LlamaModel(cfg).init_params(torch.Generator().manual_seed(4)).state_dict()
    seen, pieces = {}, list(model.param_chunks(torch.Generator().manual_seed(4), chunk=300))
    for name, start, values in pieces:
        assert start == seen.get(name, 0) and values.numel() <= 300
        seen[name] = start + values.numel()
    assert seen == {n: s.numel() for n, s in shapes.items()}
    got = {}
    for name, start, values in pieces:
        got.setdefault(name, []).append(values)
    got = {n: torch.cat(v).view(shapes[n]) for n, v in got.items()}
    assert {n: w.shape for n, w in got.items()} == {n: w.shape for n, w in whole.items()}
    proj = 0.02 / np.sqrt(2 * cfg.n_layer)
    for name, w in got.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("_g"):
            assert torch.equal(w, torch.ones_like(w)), name
        else:
            want = proj if leaf in ("o_w", "down_w") else 0.02
            assert abs(w.std().item() - want) < 0.1 * want, name
    assert all(p.requires_grad for p in tllama.LlamaModel(cfg).parameters())


def test_param_chunks_equal_init_params_bit_for_bit():
    cfg = _tcfg()
    a = tllama.LlamaModel(cfg).init_params(torch.Generator().manual_seed(5)).state_dict()
    chunks = tllama.LlamaModel(cfg).param_chunks(torch.Generator().manual_seed(5))
    from deepspeed_tpu_torch.models.common import assemble

    b = assemble(tllama.LlamaModel(cfg), chunks).state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)


# ------------------------------------------------------------------ engine
def test_zero_init_with_offload_equals_the_run_in_memory():
    """Weights drawn by ``zero.Init`` at stage 3 with the params in host
    memory, trained with both offloads, against the whole-tree weights of
    the same seed trained in memory at stage 0."""
    from deepspeed_tpu_torch.runtime import zero

    cfg = _tcfg(tie_embeddings=True)
    gen = lambda: torch.Generator().manual_seed(8)
    offload = dict(offload_optimizer={"device": "cpu"}, offload_param={"device": "cpu"})
    model = tllama.LlamaModel(cfg)
    with zero.Init(config=_config(3, **offload), device="cpu"):
        zero.materialize(model, gen())
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=_config(3, **offload),
                                                device="cpu")
    assert engine._offload is not None and model.param_gatherer is engine._zero
    ref, *_ = deepspeed_tpu_torch.initialize(
        model=tllama.LlamaModel(cfg).init_params(gen()), config=_config(0), device="cpu")
    batch = _batch(8 * GAS, mask=True)
    for eng in (engine, ref):
        eng.losses = [float(eng.train_batch(batch)) for _ in range(STEPS)]
    np.testing.assert_allclose(engine.losses, ref.losses, rtol=1e-5)
    got, want = _params_of(engine), _params_of(ref)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-6, err_msg=name)
