"""The port's flash-attention forward against the JAX package.

On the CPU the port's wrapper runs its plain version; the JAX side runs the
Pallas kernel in interpret mode, as tests/unit/test_flash_attention.py does.
Both sides compute in fp32 on the CPU and differ only in summation order,
hence atol = rtol = 2e-5. The kernel itself runs only on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.pallas.flash_attention as jfa
from deepspeed_tpu_torch.ops.pallas import flash_attention as tfa

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    if jax.default_backend() != "tpu":
        from jax.experimental import pallas as pl

        monkeypatch.setattr(jfa.pl, "pallas_call",
                            functools.partial(pl.pallas_call, interpret=True))
    yield


def _qkv(shape, seed):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,block", [(128, 32), (192, 64)])   # tri grid; rect grid
def test_matches_jax_flash_attention(causal, T, block):
    q, k, v = _qkv((1, T, 2, 64), seed=T)
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                              block_q=block, block_k=block)
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_matches_mha_reference(causal):
    q, k, v = _qkv((2, 128, 2, 64), seed=3)
    ref = np.asarray(jfa.mha_reference(*map(jnp.asarray, (q, k, v)), causal=causal))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    np.testing.assert_allclose(tfa.flash_attention(tq, tk, tv, causal=causal).numpy(),
                               ref, **TOL)
    np.testing.assert_allclose(tfa.mha_reference(tq, tk, tv, causal=causal).numpy(),
                               ref, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_jax_flash_forward(causal):
    T, D = 128, 64
    scale = 1.0 / np.sqrt(D)
    q, k, v = _qkv((2, T, D), seed=4)
    o_j, lse_j = jfa._flash_forward(*map(jnp.asarray, (q, k, v)), scale, causal, 32, 32)
    o_t, lse_t = tfa.flash_forward(torch.from_numpy(q * np.float32(scale)),
                                   torch.from_numpy(k), torch.from_numpy(v), causal)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], **TOL)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv((2, 16, 64), seed=5))
    before = tfa.KERNEL.launches
    o, lse = tfa.flash_forward(q, k, v, causal=True)
    o_ref, lse_ref = tfa.mha_reference_lse(q, k, v, causal=True)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert tfa.KERNEL.launches == before


@pytest.mark.parametrize("bad,err", [
    (dict(d=80), ValueError),                       # head dim the kernel lacks
    (dict(dtype=torch.float64), TypeError),
    (dict(noncontig=True), ValueError),
    (dict(t_k=0), ValueError),
])
def test_kernel_checks_reject_what_it_does_not_take(bad, err):
    d, t_k = bad.get("d", 64), bad.get("t_k", 16)
    dtype = bad.get("dtype", torch.float32)
    q = torch.zeros(2, 16, d, dtype=dtype)
    k = torch.zeros(2, t_k, d, dtype=dtype)
    if bad.get("noncontig"):
        k = torch.zeros(2, d, t_k, dtype=dtype).transpose(1, 2)
    with pytest.raises(err):
        tfa._check(q, k, k.clone() if not bad.get("noncontig") else k)
