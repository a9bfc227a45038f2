"""Weight quantization, ``ops/quantizer.py``, against the JAX package's, on
the CPU (int8 serving: ``test_torch_quantized_serving.py``).

The same float tensors (numpy draws) quantized by
both packages at int8 and int4, symmetric and asymmetric, with groups that
divide the contraction dim, that pad it, that exceed it, odd int4 groups,
``q_groups`` and 1-D tensors. The codes must equal JAX's; a code may
differ only where the scaled value sits on a rounding tie (counted, and at
most one in a thousand), the scales and zero points match to 1e-6
relative, and the dequantized weights to one code step at such a tie and
1e-6 relative elsewhere. ``quantize_params`` picks the tensors JAX picks
(names, ``min_numel``, the exclusions); the byte counts agree. The fp32
cases run the JAX functions jitted (compiled once per shape); the bf16
case runs them eagerly, op by op, as the JAX engine calls them.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import quantizer as tq

# (shape, group size): dividing, exceeding, odd and padding, stacked, 1-D
SHAPES = [((64, 48), 16), ((24, 8), 64), ((33, 20), 7), ((3, 40, 24), 16), ((50,), 8)]


def _jq():
    from deepspeed_tpu.ops import quantizer as jq

    return jq


def _compare(jleaf, tleaf):
    """Codes equal but at rounding ties; scales/zeros at 1e-6 relative.
    Returns the number of codes that differ."""
    jcodes, tcodes = np.asarray(jleaf.q), tleaf.q.numpy()
    assert jcodes.shape == tcodes.shape and tleaf.num_bits == jleaf.num_bits
    assert tleaf.shape == tuple(jleaf.shape)
    np.testing.assert_allclose(tleaf.scale.numpy(), np.asarray(jleaf.scale), rtol=1e-6)
    assert (tleaf.zero is None) == (jleaf.zero is None)
    if tleaf.zero is not None:
        np.testing.assert_allclose(tleaf.zero.numpy(), np.asarray(jleaf.zero), rtol=1e-6,
                                   atol=1e-7)
    differ = int((jcodes != tcodes).sum())
    assert differ <= max(1, jcodes.size // 1000), differ
    return differ


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "asym"])
def test_quantize_and_dequantize_match_jax(bits, symmetric):
    import jax
    import jax.numpy as jnp

    jq = _jq()
    rs = np.random.RandomState(bits + symmetric)
    for shape, gs in SHAPES:
        w = (rs.standard_normal(shape) * rs.uniform(0.01, 3.0)).astype(np.float32)
        j = jax.jit(jq.quantize_tensor, static_argnums=(1, 2, 3))(jnp.asarray(w), bits, gs,
                                                                  symmetric)
        t = tq.quantize_tensor(torch.from_numpy(w), bits, gs, symmetric)
        ties = _compare(j, t)
        jd = np.asarray(jax.jit(jq.dequantize_tensor)(j))
        td = tq.dequantize_tensor(t).numpy()
        assert td.shape == shape and td.dtype == np.float32
        step = float(t.scale.max()) * (1.0 + 1e-6)
        off = np.abs(td - jd)
        assert (off > 1e-6 * np.abs(jd) + 1e-7).sum() <= ties, shape
        assert off.max() <= step, shape
        assert t.nbytes == j.nbytes, shape
        # a quantized tensor is within half a code step of the original
        assert np.abs(td - w).max() <= 0.5 * step + 1e-6


def test_bf16_weights_and_q_groups_match_jax():
    import jax.numpy as jnp

    jq = _jq()
    w = np.random.RandomState(9).standard_normal((96, 40)).astype(np.float32)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    for bits in (8, 4):
        j = jq.Quantizer(q_groups=3, num_bits=bits).quantize(wj)
        t = tq.Quantizer(q_groups=3, num_bits=bits).quantize(wt)
        _compare(j, t)
        assert t.dtype == torch.bfloat16 and t.q.shape[-3] == 3
        got = tq.Quantizer().dequantize(t)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(jq.dequantize_tensor(j)).astype(np.float32))
    with pytest.raises(ValueError, match="num_bits"):
        tq.quantize_tensor(wt, num_bits=3)


def test_quantize_params_picks_what_jax_picks():
    import functools

    import jax
    import jax.numpy as jnp

    jq = _jq()
    rs = np.random.RandomState(4)
    tree = {"wte": rs.standard_normal((64, 32)), "h.q_w": rs.standard_normal((32, 32)),
            "h.ln_g": rs.standard_normal((2, 32)), "h.fc_bias": rs.standard_normal((32, 64)),
            "h.small": rs.standard_normal((8, 8)), "h.ids": rs.randint(0, 9, (64, 64)),
            "head": rs.standard_normal((32, 64))}
    tree = {k: v.astype(np.float32 if v.dtype.kind == "f" else np.int32)
            for k, v in tree.items()}
    for kw in ({"min_numel": 256}, {"min_numel": 256, "num_bits": 4, "q_groups": 4},
               {"min_numel": 4096}, {"min_numel": 16, "exclude": ("q_w",)}):
        j = jax.jit(functools.partial(jq.quantize_params, **kw))(
            {k: jnp.asarray(v) for k, v in tree.items()})
        t = tq.quantize_params({k: torch.from_numpy(v) for k, v in tree.items()}, **kw)
        picked = sorted(k for k, v in t.items() if tq.is_quantized_leaf(v))
        assert picked == sorted(k for k, v in j.items() if jq.is_quantized_leaf(v)), kw
        for k in picked:
            _compare(j[k], t[k])
        assert tq.quantized_nbytes(t) == jq.quantized_nbytes(j)
        back = tq.dequantize_params(t, torch.bfloat16)
        assert back["h.ids"].dtype == torch.int32 and back["wte"].dtype == torch.bfloat16
