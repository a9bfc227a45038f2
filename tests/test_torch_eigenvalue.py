"""The port's block Hessian eigenvalue against the JAX package.

Power iteration on a known quadratic (exact to 1e-3), ``post_process``, a
2-layer fp32 GPT-2's per-layer eigenvalues against JAX's from the same
start vector (the JAX draws fed to the port; rtol 1e-4), MoQ's per-layer
stretch of the quantization windows against JAX's ``CompressionTransform``
for the same installs (forward only; future stages extended), the engine's
gas-boundary update (its factors installed, the estimate launching no
attention kernel entry), and the block disabled. JAX's estimator compiles
a jvp of a gradient, so it runs once in this file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.compression import compress as jcomp
from deepspeed_tpu.compression.config import CompressionConfig as JCompressionConfig
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime import eigenvalue as jev
from deepspeed_tpu_torch.compression import compress as tcomp
from deepspeed_tpu_torch.compression.config import CompressionConfig as TCompressionConfig
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.common import plain_math
from deepspeed_tpu_torch.runtime import eigenvalue as tev

SMALL = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2, n_head=2, remat=False,
             use_flash_attention=False)


def test_power_iteration_known_quadratic():
    """loss = 1/2 sum_l c_l |w_l|^2: block l's Hessian is c_l I, so its top
    eigenvalue is c_l exactly."""
    coeffs = [1.0, 4.0, 2.0]
    params = {f"blocks.{i}.w": torch.ones(5, requires_grad=True) for i in range(3)}
    params["other"] = torch.ones(2, requires_grad=True)

    def loss():
        return sum(0.5 * c * params[f"blocks.{i}.w"].square().sum()
                   for i, c in enumerate(coeffs)) + params["other"].square().sum()

    evs = tev.block_eigenvalues(loss, params, max_iter=50, tol=1e-4,
                                generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(evs.numpy(), coeffs, rtol=1e-3)


@pytest.mark.parametrize("evs", [[2.0, -4.0, 0.0], [0.0, 0.0], [0.3, 0.1, 0.2, 0.05]])
def test_post_process_matches_jax(evs):
    np.testing.assert_allclose(tev.post_process(torch.tensor(evs)).numpy(),
                               np.asarray(jev.post_process(jnp.asarray(evs))), rtol=1e-6)


def _jax_v0(blocks, rng, L):
    """The start vectors JAX's ``block_eigenvalues`` draws from ``rng``:
    per layer, one key per block leaf in the dict's sorted order."""
    keys = sorted(blocks)
    out = []
    for lk in jax.random.split(rng, L):
        ks = jax.random.split(lk, len(keys))
        out.append({k: np.asarray(jax.random.normal(kk, blocks[k].shape[1:], jnp.float32))
                    for k, kk in zip(keys, ks)})
    return out


@pytest.fixture(scope="module")
def gpt2_pair():
    shapes = jax.eval_shape(lambda: jgpt2.GPT2Model(jgpt2.GPT2Config(
        **SMALL, dtype=jnp.float32)).init_params(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(0)
    np_params = jax.tree.map(lambda s: (0.05 * rs.randn(*s.shape)).astype(np.float32), shapes)
    batch = {"input_ids": rs.randint(0, SMALL["vocab_size"], size=(2, 16)).astype(np.int32)}
    return np_params, batch


def test_gpt2_block_eigenvalues_match_jax_from_the_same_v0(gpt2_pair):
    """Both stop at the relative tolerance (or 8 products) on the same
    iterates; JAX's loss without its chunk remat (the port's plain_math
    turns it off too)."""
    np_params, batch = gpt2_pair
    max_iter, tol = 8, 1e-2
    jmodel = jgpt2.GPT2Model(jgpt2.GPT2Config(**SMALL, remat_loss_chunks=False,
                                              dtype=jnp.float32))
    params = jax.tree.map(jnp.asarray, np_params)
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(lambda p: jev.block_eigenvalues(
        lambda q: jmodel.loss(q, batch), p, rng, max_iter=max_iter, tol=tol))(params))
    model = tgpt2.params_from_jax(np_params, tgpt2.GPT2Config(**SMALL, dtype=torch.float32))
    ids = torch.from_numpy(batch["input_ids"]).long()
    with plain_math(model):
        got = tev.block_eigenvalues(lambda: model.loss({"input_ids": ids}),
                                    dict(model.named_parameters()), max_iter=max_iter, tol=tol,
                                    v0=_jax_v0(np_params["blocks"], rng, 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


def _moq(offset, period, start=8, target=6):
    return {"compression_training": {"weight_quantization": {
        "shared_parameters": {"enabled": True, "schedule_offset": offset,
                              "quantization_period": period},
        "different_groups": {"q1": {"params": {"start_bits": start, "target_bits": target},
                                    "modules": ["blocks"]}}}}}


@pytest.mark.parametrize("case", ["forward_only", "future_stages"])
def test_moq_stretch_matches_jax(case):
    """The JAX file's two stretch cases on a (2, 3, 3) stacked leaf: an
    install at step 10 never reopens an earlier stage; an install before
    the schedule stretches a factor-3 layer's stages to 3 periods."""
    offset, period, factors, at, steps = {
        "forward_only": (0, 4, [5, 1], 10, range(0, 40)),
        "future_stages": (100, 10, [3, 1], 0, range(0, 220, 5))}[case]
    cfg = _moq(offset, period)
    jshapes = {"blocks": {"w": jnp.zeros((2, 3, 3))}}
    jtr = jcomp.CompressionTransform(JCompressionConfig.from_ds_config(cfg), jshapes)
    ttr = tcomp.CompressionTransform(TCompressionConfig.from_ds_config(cfg),
                                     {f"blocks.{i}.w": torch.zeros(3, 3) for i in range(2)})
    assert ttr.set_eigenvalue_factors(factors, step=at) == jtr.set_eigenvalue_factors(
        factors, step=at)
    jplan = next(p for p in jtr._plans if p)
    tplan = next(p for p in ttr._plans if p)
    for je, te in zip(jplan, tplan):
        joff, jend = jtr._stretched_window(je, jshapes["blocks"]["w"], "blocks/w")
        toff, tend = ttr._stretched_window(te, (2, 3, 3), "blocks/w")
        np.testing.assert_array_equal(np.asarray(toff), np.asarray(joff))
        assert (jend is None) == (tend is None)
        if jend is not None:
            np.testing.assert_array_equal(np.asarray(tend), np.asarray(jend))
    for step in steps:
        assert ttr.any_precision_switch(step) == jtr.any_precision_switch(step), step
    if case == "forward_only":
        off2, _ = ttr._stretched_window(tplan[2], (2, 3, 3), "blocks/w")
        assert (np.asarray(off2) <= 10).all()
        assert not ttr.any_precision_switch(10)
    else:
        off1, end1 = ttr._stretched_window(tplan[1], (2, 3, 3), "blocks/w")
        np.testing.assert_array_equal(off1, [130, 110])
        np.testing.assert_array_equal(end1, [160, 120])


def _engine(extra=None, flash=False):
    cfg = {"train_batch_size": 4, "steps_per_print": 0,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, **_moq(2, 4, 8, 4)}
    cfg.update(extra or {})
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**{**SMALL, "use_flash_attention": flash},
                                             dtype=torch.float32))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    batch = {"input_ids": np.random.RandomState(0).randint(0, SMALL["vocab_size"],
                                                          size=(4, 16))}
    return engine, batch


def test_engine_installs_per_layer_factors_without_kernels(monkeypatch):
    """A gas-boundary update runs power iteration on the raw weights with
    the plain attention: the flash entry is not called inside the estimate
    (the train step calls it once per layer), and the factors stretch the
    stacked leaves' windows per layer."""
    from deepspeed_tpu_torch.ops.pallas import flash_attention as fa

    engine, batch = _engine({"eigenvalue": {"enabled": True, "max_iter": 4,
                                            "gas_boundary_resolution": 1}}, flash=True)
    assert engine.eigenvalue_enabled()
    calls = {"n": 0}
    real = fa.flash_forward

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(fa, "flash_forward", counted)
    estimate = engine._maybe_update_eigenvalue
    seen = {}

    def watched(b):
        before = calls["n"]
        estimate(b)
        seen["estimate"] = calls["n"] - before

    engine._maybe_update_eigenvalue = watched
    engine.train_batch(batch)
    assert calls["n"] - seen["estimate"] == SMALL["n_layer"] and seen["estimate"] == 0
    assert set(engine.block_eigenvalue) == {0, 1}
    assert all(0.0 <= v <= 1.0 for v, _ in engine.block_eigenvalue.values())
    comp = engine._compression
    assert comp._ev_factors is not None and all(f >= 1 for f in comp._ev_factors)
    entry = next(e for plan, path in zip(comp._plans, comp._paths)
                 if path == "blocks/qkv_w" for e in plan)
    off, _ = comp._stretched_window(entry, (2, 32, 96), "blocks/qkv_w")
    assert np.asarray(off).shape == (2,)
    # the raw weights were restored: the model reads the compressed ones again
    assert engine.module.param_gatherer is engine._compressed


def test_eigenvalue_disabled_is_inert_and_missing_layers_give_nothing():
    engine, batch = _engine()
    assert engine.eigenvalue is None and not engine.eigenvalue_enabled()
    engine.train_batch(batch)
    assert engine._compression._ev_factors is None
    assert tev.Eigenvalue(layer_name="nope").compute_eigenvalue(
        lambda: torch.zeros(()), dict(engine.module.named_parameters())) == {}
