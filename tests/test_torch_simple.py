"""The port's SimpleModel against the JAX package's.

The same weights (the JAX ``init_params``, carried across by
``params_from_jax``) and the same numpy batch: the loss and every gradient
against ``jax.grad``, and three ``train_batch`` steps of the port's engine
(one process on the CPU) against the JAX engine (the conftest's 8-device
CPU mesh, data parallel). Both sides compute in fp32 and differ only in
summation order: 1e-5 for one loss and its gradients, 1e-4 after three
Adam steps (as tests/test_torch_train.py). JAX is imported inside the test
functions.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import simple as tsimple

HIDDEN, LAYERS = 32, 3


def _batch(rows=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, HIDDEN)).astype(np.float32),
            rng.normal(size=(rows, HIDDEN)).astype(np.float32))


def _pair():
    import jax

    from deepspeed_tpu.models import simple as jsimple

    jm = jsimple.SimpleModel(hidden_dim=HIDDEN, nlayers=LAYERS)
    params = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    return jm, params, tsimple.params_from_jax(params, HIDDEN, LAYERS)


def test_loss_and_every_gradient_match_jax():
    import jax

    jm, params, tm = _pair()
    x, y = _batch()
    jloss, jgrads = jax.value_and_grad(jm.loss)(params, (x, y))
    loss = tm.loss((torch.from_numpy(x), torch.from_numpy(y)))
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for i, layer in enumerate(tm.layers):
        for k in ("w", "b"):
            np.testing.assert_allclose(getattr(layer, k).grad.numpy(),
                                       np.asarray(jgrads["layers"][i][k]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"layers.{i}.{k}")


def test_random_dataset_and_init_match_jax():
    from deepspeed_tpu.models import simple as jsimple

    for (tx, ty), (jx, jy) in zip(tsimple.random_dataset(4, HIDDEN, seed=3),
                                  jsimple.random_dataset(4, HIDDEN, seed=3)):
        assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
    model = tsimple.SimpleModel(HIDDEN, LAYERS)
    assert all(p.is_meta for p in model.parameters())
    model.init_params(torch.Generator().manual_seed(0))
    w = model.layers[0].w.detach()
    assert w.shape == (HIDDEN, HIDDEN) and float(w.std()) == pytest.approx(0.1, rel=0.15)
    assert not model.layers[0].b.detach().any()


@pytest.mark.parametrize("stage", [0, 1])
def test_three_train_batch_steps_match_the_jax_engine(stage):
    import jax

    import deepspeed_tpu
    from deepspeed_tpu.models import simple as jsimple

    cfg = {"train_batch_size": 16, "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "zero_optimization": {"stage": stage}, "steps_per_print": 0}
    jm, params, tm = _pair()
    jeng, *_ = deepspeed_tpu.initialize(model=jsimple.SimpleModel(HIDDEN, LAYERS),
                                        model_parameters=params, config=dict(cfg))
    teng, *_ = deepspeed_tpu_torch.initialize(model=tm, config=dict(cfg), device="cpu")
    batch = _batch(seed=1)
    jl = [float(jeng.train_batch(batch)) for _ in range(3)]
    tl = [float(teng.train_batch(batch)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    jp = jax.tree_util.tree_map(np.asarray, jeng.state.params)
    for i, layer in enumerate(teng.module.layers):
        for k in ("w", "b"):
            np.testing.assert_allclose(getattr(layer, k).detach().numpy(), jp["layers"][i][k],
                                       rtol=1e-4, atol=1e-5, err_msg=f"layers.{i}.{k}")
