"""The MoE GPT-2 with ``sparse_attention``, in the port against the JAX
package, on the CPU.

Both halves of every pair attend block-sparsely (GPT-2's ``_attention`` →
``SparseSelfAttention``, the sparse kernels' plain versions here): the
loss and every gradient match the JAX ``MoEGPT2``'s with its Pallas sparse
kernels interpreted, at ``test_torch_gpt2_moe.py``'s tolerances; the first
block's logits are the dense model's and the masked queries' are not; a
sparse model is not served, as in JAX.
"""

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_gpt2_moe import (GRAD_TOL, LOSS_TOL, TINY, _jax_leaf, _jax_model,
                                       _jax_params, _port, _torch)


SPARSE = {"mode": "fixed", "block": 16, "num_local_blocks": 2, "num_global_blocks": 1}
SPARSE_SEQ = 64


@pytest.fixture
def _interpreted_sparse_kernels(monkeypatch):
    """The JAX model's real Pallas sparse kernels, interpreted on the CPU
    (``tests/unit/test_flash_attention.py``'s monkeypatch; the model takes
    them off the TPU under ``DS_TPU_SPARSE_INTERPRET``)."""
    from jax.experimental import pallas as pl

    import deepspeed_tpu.ops.pallas.flash_attention as fa

    monkeypatch.setattr(fa.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setenv("DS_TPU_SPARSE_INTERPRET", "1")


def test_sparse_moe_loss_and_every_gradient_match_jax(_interpreted_sparse_kernels):
    import jax

    over = dict(n_positions=64, sparse_attention=SPARSE)
    params = _jax_params(seed=14)
    params["wpe"] = np.concatenate([params["wpe"], params["wpe"]])       # 64 positions
    rs = np.random.RandomState(14)
    batch = {"input_ids": rs.randint(0, TINY["vocab_size"], size=(2, SPARSE_SEQ))
             .astype(np.int32)}
    jm = _jax_model(**over)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, batch))(params)
    model = _port(params, **over)
    loss = model.loss(_torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    for name, p in model.named_parameters():
        want = _jax_leaf(jgrads, name)
        if p.grad is None:
            assert name.startswith(("blocks.1.fc", "blocks.3.fc")) and not want.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want, err_msg=name, **GRAD_TOL)
    dense = _port(params, n_positions=64)
    ids = torch.from_numpy(batch["input_ids"]).long()
    with torch.no_grad():
        gap = (dense.apply(ids) - model.apply(ids)).abs()
    # the layout did something: the first block's logits are those of the
    # dense model, the masked queries' differ
    assert gap[:, :16].max() < 1e-5 < gap[:, 32:].max()
    with pytest.raises(NotImplementedError, match="sparse_attention"):
        model.init_cache(1, 16)                 # a sparse model is not served, as in JAX
