"""The port's flash-attention backward against the JAX package.

On the CPU the port's ``flash_attention`` is a ``torch.autograd.Function``
whose backward runs the kernels' plain version (``mha_backward_reference``);
the JAX side differentiates its own ``flash_attention``, whose custom VJP
runs the Pallas backward kernels in interpret mode (the monkeypatch of
tests/test_torch_flash_attention.py). Both compute in fp32 on the CPU and
differ only in summation order over at most 192 keys, hence
atol = rtol = 1e-4 on gradients of order one. The kernels themselves run
only on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.pallas.flash_attention as jfa
from deepspeed_tpu_torch.ops.pallas import flash_attention as tfa

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    if jax.default_backend() != "tpu":
        from jax.experimental import pallas as pl

        monkeypatch.setattr(jfa.pl, "pallas_call",
                            functools.partial(pl.pallas_call, interpret=True))
    yield


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(shape).astype(np.float32) for _ in range(4)]   # q, k, v, dO


def _torch_grads(fn, q, k, v, do):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    fn(tq, tk, tv).backward(torch.from_numpy(do))
    return [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("d", [64, 96])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,block", [(128, 32), (192, 64)])   # tri grid (nq=4); rect grid
def test_grads_match_jax_flash_attention(d, causal, T, block):
    q, k, v, do = _inputs((1, T, 2, d), seed=T + d)

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, block_q=block, block_k=block)
        return jnp.sum(o * jnp.asarray(do))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _torch_grads(lambda q, k, v: tfa.flash_attention(q, k, v, causal=causal), q, k, v, do)
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g, np.asarray(r), err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_grads_match_autograd_through_mha_reference(causal):
    q, k, v, do = _inputs((2, 96, 2, 64), seed=7)
    got = _torch_grads(lambda q, k, v: tfa.flash_attention(q, k, v, causal=causal), q, k, v, do)
    ref = _torch_grads(lambda q, k, v: tfa.mha_reference(q, k, v, causal=causal), q, k, v, do)
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g, r, err_msg=f"d{name}", **TOL)


def test_backward_matches_jax_flash_backward_on_bhtd():
    """``flash_backward`` on (B*H, T, D) with the scale in q against the JAX
    ``_flash_backward`` on the same residuals."""
    T, D = 128, 64
    q, k, v, do = _inputs((2, T, D), seed=11)
    q = q * np.float32(1.0 / np.sqrt(D))
    o_j, lse_j = jfa._flash_forward(*map(jnp.asarray, (q, k, v)), 1.0, True, 32, 32)
    ref = jfa._flash_backward((*map(jnp.asarray, (q, k, v)), o_j, lse_j), jnp.asarray(do),
                              1.0, True, 32, 32)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_forward(tq, tk, tv, causal=True)
    before = tfa.BWD_KERNEL.launches
    got = tfa.flash_backward(tq, tk, tv, o, lse, tdo, causal=True)
    assert tfa.BWD_KERNEL.launches == before          # CPU tensors: the plain version
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=f"d{name}", **TOL)

