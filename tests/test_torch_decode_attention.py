"""The port's decode attention against the JAX package's decode kernel.

The cases of tests/unit/test_decode_attention.py. On the CPU the port's
wrapper runs its plain version; the JAX kernel interprets itself off the
TPU. Both sides are fp32 on the CPU, so the tolerance is 2e-5, as in the JAX
test. The kernel itself runs only on the card (tests/test_torch_cuda.py
and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.pallas.decode_attention as jda
from deepspeed_tpu_torch.inference import config as tconfig
from deepspeed_tpu_torch.ops.pallas import decode_attention as tda
from deepspeed_tpu_torch.ops.pallas import flash_attention as tfa

TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(B, S, H, KV, Dh, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((B, H, Dh)).astype(np.float32)
    k = rs.standard_normal((B, S, KV, Dh)).astype(np.float32)
    v = rs.standard_normal((B, S, KV, Dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("kv", [4, 2, 1])          # MHA, GQA, MQA
@pytest.mark.parametrize("pos", [0, 63, 64, 200, 255])
def test_matches_jax_decode_attention(kv, pos):
    q, k, v = _rand(2, 256, 4, kv, 64)
    ref = jda.decode_attention(*map(jnp.asarray, (q, k, v)), jnp.int32(pos), block_k=64)
    out = tda.decode_attention(*map(torch.from_numpy, (q, k, v)), pos)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_garbage_beyond_pos_ignored():
    q, k, v = _rand(1, 128, 2, 1, 64, seed=1)
    pos = 40
    ref = jda.decode_attention(*map(jnp.asarray, (q, k, v)), jnp.int32(pos), block_k=32)
    k_dirty, v_dirty = k.copy(), v.copy()
    k_dirty[:, pos + 1:] = 1e9
    v_dirty[:, pos + 1:] = -1e9
    out = tda.decode_attention(*map(torch.from_numpy, (q, k_dirty, v_dirty)), pos)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_tensor_pos_matches_int_pos():
    q, k, v = map(torch.from_numpy, _rand(2, 96, 4, 2, 64, seed=2))
    a = tda.decode_attention(q, k, v, 95)
    b = tda.decode_attention(q, k, v, torch.tensor(95, dtype=torch.int32))
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad,err", [
    (dict(kv=3), ValueError),                       # H % KV != 0
    (dict(dh=48), ValueError),                      # head dim the kernel lacks
    (dict(dtype=torch.float64), TypeError),
    (dict(pos_dtype=torch.int64), ValueError),
])
def test_kernel_checks_reject_what_it_does_not_take(bad, err):
    dtype, dh, kv = bad.get("dtype", torch.float32), bad.get("dh", 64), bad.get("kv", 2)
    q = torch.zeros(2, 6 if kv == 3 else 4, dh, dtype=dtype)
    k = torch.zeros(2, 16, 4 if kv == 3 else kv, dh, dtype=dtype)
    pos = torch.tensor(3, dtype=bad.get("pos_dtype", torch.int32))
    with pytest.raises(err):
        tda._check(q, k, k.clone(), pos)


@pytest.mark.parametrize("name", sorted(tconfig._DTYPES))
def test_every_serving_dtype_has_a_kernel_instance(name):
    """Every dtype the inference config accepts has a dtype code in the
    decode and flash wrappers, so serving in it on the card launches the
    kernels; the code table is the C dispatch's."""
    dtype = tconfig.DeepSpeedInferenceConfig(dtype=name).torch_dtype()
    assert dtype in tda._DTYPE_CODES and dtype in tfa._DTYPE_CODES
    assert tda._DTYPE_CODES == tfa._DTYPE_CODES


@pytest.mark.parametrize("kv", [4, 1])
def test_fp16_plain_version_matches_jax(kv):
    """fp16 inputs through both packages' einsum decode (the JAX decode
    kernel's reference; the port's plain version), which round the scores
    and probabilities to fp16 alike: held at the bf16 tolerance, 2e-2."""
    q, k, v = (x.astype(np.float16) for x in _rand(2, 96, 4, kv, 64, seed=3))
    ref = jda.decode_reference(*map(jnp.asarray, (q, k, v)), jnp.int32(70))
    out = tda.decode_attention(*map(torch.from_numpy, (q, k, v)), 70)
    assert out.dtype == torch.float16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, dtype=np.float32),
                               atol=2e-2, rtol=2e-2)
