"""The port's decode attention against the JAX package's decode kernel.

The cases of tests/unit/test_decode_attention.py. On the CPU the port's
wrapper runs its plain version; the JAX kernel interprets itself off the
TPU. Both sides are fp32 on the CPU, so the tolerance is 2e-5, as in the JAX
test. The kernel's split over the cache (``decode_split_reference``, the
chunk choice) is held against the same JAX kernel. The kernel itself runs
only on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.pallas.decode_attention as jda
from deepspeed_tpu_torch.inference import config as tconfig
from deepspeed_tpu_torch.ops.pallas import decode_attention as tda
from deepspeed_tpu_torch.ops.pallas import flash_attention as tfa

TOL = dict(atol=2e-5, rtol=2e-5)
# compiled once per shape (``pos`` traced): interpreted op by op, each call
# of the JAX kernel takes about a second here
_jax_decode = jax.jit(jda.decode_attention, static_argnames="block_k")


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
    ref = _jax_decode(*map(jnp.asarray, (q, k, v)), jnp.int32(pos), block_k=64)
    out = tda.decode_attention(*map(torch.from_numpy, (q, k, v)), pos)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_garbage_beyond_pos_ignored():
    q, k, v = _rand(1, 128, 2, 1, 64, seed=1)
    pos = 40
    ref = _jax_decode(*map(jnp.asarray, (q, k, v)), jnp.int32(pos), block_k=32)
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


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-5), (jnp.bfloat16, 2e-2)])
@pytest.mark.parametrize("dh", tda.HEAD_DIMS)
@pytest.mark.parametrize("h,kv", [(2, 2), (4, 2), (4, 1)])     # MHA, GQA, MQA
@pytest.mark.parametrize("pos", [0, 63, 64, 191])               # chunk 64: 0, c-1, c, S-1
def test_split_reference_matches_jax_kernel_and_plain(pos, h, kv, dh, dtype, tol):
    """The kernel's split, in plain PyTorch, over three 64-key chunks of a
    192-entry cache: chunks past pos get exactly zero weight, and the merge
    gives the JAX kernel's output (fp32 2e-5, the JAX test's tolerance; bf16
    2e-2: both round their fp32 result to bf16) and the plain version's on
    the same inputs."""
    q, k, v = _rand(1, 192, h, kv, dh, seed=dh + 7 * kv + h)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    ref = np.asarray(_jax_decode(jq, jk, jv, jnp.int32(pos), block_k=64), np.float32)
    tq, tk, tv = (torch.from_numpy(np.array(x, np.float32)) for x in (jq, jk, jv))
    if dtype == jnp.bfloat16:
        tq, tk, tv = (x.to(torch.bfloat16) for x in (tq, tk, tv))
    out = tda.decode_split_reference(tq, tk, tv, torch.tensor(pos, dtype=torch.int32), 64)
    assert out.dtype == tq.dtype
    plain = tda.decode_reference(tq.float(), tk.float(), tv.float(), pos).to(tq.dtype)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=tol)
    np.testing.assert_allclose(out.float().numpy(), plain.float().numpy(), atol=tol, rtol=tol)


def test_split_reference_never_reads_past_pos():
    """NaN and +-1e9 past pos change nothing: the split masks the scores and
    zeroes the V rows there, as the kernel never reads them."""
    q, k, v = map(torch.from_numpy, _rand(2, 256, 4, 2, 64, seed=4))
    clean = tda.decode_split_reference(q, k, v, 100, 64)
    k[:, 101:] = 1e9
    k[:, 101::2] = -1e9
    v[:, 101:] = float("nan")
    assert torch.equal(tda.decode_split_reference(q, k, v, 100, 64), clean)


@pytest.mark.parametrize("batch,kv,capacity", [(32, 8, 256), (4, 8, 8192), (1, 8, 32768),
                                               (1, 1, 8192)])
def test_decode_chunk_fills_the_card_from_the_capacity(batch, kv, capacity):
    """On the H100's 132 SMs the grid over (batch row, KV head, chunk) has
    CTAS_PER_SM to twice that CTAs per SM at the serving shape (B=32, S=256,
    one chunk) and at the long ones (B=4, S=8192: 8 chunks of 1024), with the
    longest chunk that keeps it so; the chunk is a multiple of the 64-key
    tile and a function of the capacity, never of pos. A grid that cannot
    fill the card (B=1, one KV head) takes the smallest chunk, the tile."""
    n_sm = 132
    chunk = tda.decode_chunk(batch, kv, capacity, n_sm)
    ctas = batch * kv * -(-capacity // chunk)
    assert chunk % tda.TILE_KEYS == 0
    assert ctas >= tda.CTAS_PER_SM * n_sm or chunk == tda.TILE_KEYS   # else the tile
    assert chunk >= capacity or ctas < 2 * tda.CTAS_PER_SM * n_sm
    assert "pos" not in inspect.signature(tda.decode_chunk).parameters
    assert {(32, 256): 256, (4, 8192): 1024, (1, 32768): 1024,
            (1, 8192): 64}[batch, capacity] == chunk


def test_decode_chunk_of_a_small_cache_is_one_tile():
    """A cache shorter than a tile is one chunk: the kernel writes the
    output itself and launches no merge."""
    assert tda.decode_chunk(2, 2, 48, 132) == tda.TILE_KEYS
    assert tda.decode_chunk(1, 1, 64, 132) == tda.TILE_KEYS
