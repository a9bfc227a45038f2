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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [40, 160, 512])
def test_forward_only_head_dims_with_fewer_keys_match_jax(D, causal, dtype):
    """The UNet's head dims 40 and 160 and the VAE's 512, with Tq = 12
    queries against Tk = 7 keys (no multiple of any block; top-left causal
    when causal), against the interpreted Pallas kernel: bf16 at the JAX
    tests' 2e-2, fp32 as above."""
    rs = np.random.RandomState(D)
    q = rs.standard_normal((1, 12, 2, D)).astype(np.float32)
    k, v = (rs.standard_normal((1, 7, 2, D)).astype(np.float32) for _ in range(2))
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = jfa.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal)
    out = tfa.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal)
    assert out.dtype == tdt and out.shape == (1, 12, 2, D)
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **tol)


def test_forward_and_backward_head_dim_sets():
    """The forward kernel takes every backward head dim and the
    forward-only 40, 160, 256 and 512; the backward kernels' checks refuse
    those."""
    assert set(tfa.HEAD_DIMS) < set(tfa.FWD_HEAD_DIMS)
    assert set(tfa.FWD_HEAD_DIMS) - set(tfa.HEAD_DIMS) == {40, 160, 256, 512}
    for d in (40, 160, 256, 512):
        q = torch.zeros(2, 16, d)
        tfa._check(q, q, q.clone(), tfa.FWD_HEAD_DIMS)
        with pytest.raises(ValueError, match="head dim"):
            tfa._check_bwd(q, q, q.clone(), q.clone(), torch.zeros(2, 16), torch.zeros(2, 16))


@pytest.mark.parametrize("split", [False, True], ids=["separate", "fused_qkv_views"])
def test_batch_of_one_reaches_the_kernel_contiguous(monkeypatch, split):
    """At B = 1 the (B, T, H, D) → (B*H, T, D) reshape can stay a strided
    view, which the kernel refuses on the card; the wrapper hands it
    contiguous rows, for separate q/k/v and for views of a fused qkv
    projection alike."""
    seen = []
    real = tfa.flash_forward

    def probe(q, k, v, causal=True):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        return real(q, k, v, causal)

    monkeypatch.setattr(tfa, "flash_forward", probe)
    if split:
        qkv = torch.randn(1, 16, 3 * 2 * 32)
        q, k, v = (t.reshape(1, 16, 2, 32) for t in qkv.split(64, dim=-1))
    else:
        q, k, v = (torch.randn(1, 16, 2, 32) for _ in range(3))
    out = tfa.flash_attention(q, k, v, causal=True)
    assert seen == [True]
    torch.testing.assert_close(out, tfa.mha_reference(q, k, v, causal=True),
                               rtol=2e-5, atol=2e-5)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv((2, 16, 64), seed=5))
    before = tfa.KERNEL.launches
    o, lse = tfa.flash_forward(q, k, v, causal=True)
    o_ref, lse_ref = tfa.mha_reference_lse(q, k, v, causal=True)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert tfa.KERNEL.launches == before


@pytest.mark.parametrize("bad,err", [
    (dict(d=48), ValueError),                       # head dim the kernel lacks
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


def _offset_view(shape, dtype, offset):
    """A contiguous tensor of ``shape`` that starts ``offset`` elements into
    its storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("name", ["q", "k", "v", "do"])
def test_kernel_checks_reject_a_misaligned_view(name):
    """cp.async stages 16 bytes at a time: a view whose storage offset moves
    its start off a 16-byte boundary is refused, before any kernel runs."""
    shape, dtype = (2, 16, 64), torch.bfloat16
    t = {n: torch.zeros(shape, dtype=dtype) for n in ("q", "k", "v", "do")}
    t[name] = _offset_view(shape, dtype, 1)
    assert t[name].is_contiguous() and t[name].data_ptr() % 16
    stats = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="16-byte"):
        if name == "do":
            tfa._check_bwd(t["q"], t["k"], t["v"], t["do"], stats, stats.clone())
        else:
            tfa._check(t["q"], t["k"], t["v"])


def test_kernel_checks_take_an_aligned_offset_view():
    shape, dtype = (2, 16, 64), torch.bfloat16
    q = _offset_view(shape, dtype, 8)              # 8 bf16 = 16 bytes in
    assert q.storage_offset() == 8 and q.data_ptr() % 16 == 0
    k, v, do = (torch.zeros(shape, dtype=dtype) for _ in range(3))
    stats = torch.zeros(2, 16)
    tfa._check(q, k, v)
    tfa._check_bwd(q, k, v, do, stats, stats.clone())
