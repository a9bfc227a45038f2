"""The GPT-2 variants' serving walk against the JAX package.

The variants of ``test_torch_gpt2_variants.py``: ``prefill`` and 8
``decode_step`` calls on the same tokens (GPT-Neo's local layer past its
window, ALiBi with 6 heads, not a power of two), each step's logits within
1e-5 of JAX's largest, and the decode dispatch with ALiBi over grouped heads
and a window. fp32 on the CPU through the plain attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import common as tcommon
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from tests.test_torch_gpt2_variants import B, STEPS, T, VARIANTS, _close, _configs, _ids, _params


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_prefill_and_decode_match_jax(name):
    """Prefill, then 8 steps fed the JAX path's greedy tokens; each step's
    logits held to JAX's. GPT-Neo's local layer sees past its 8-slot window
    from step 1 on."""
    jcfg, tcfg = _configs(name)
    params = _params(jcfg, 2)
    ids = _ids(2)
    cap = T + STEPS
    jmodel = jgpt2.GPT2Model(jcfg)
    model = tgpt2.params_from_jax(params, tcfg)
    jl, jcache = jax.jit(jmodel.prefill)(params, jnp.asarray(ids), jmodel.init_cache(B, cap))
    with torch.no_grad():
        tl, tcache = model.prefill(torch.from_numpy(ids), model.init_cache(B, cap))
    _close(tl, jl, 1e-5, "prefill")
    jstep = jax.jit(jmodel.decode_step)
    for s in range(STEPS):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jcache = jstep(params, jnp.asarray(tok), jcache)
        with torch.no_grad():
            tl, tcache = model.decode_step(torch.from_numpy(tok).long(), tcache)
        _close(tl, jl, 1e-5, f"decode step {s}")
    assert int(tcache["pos"]) == int(jcache["pos"]) == cap


@pytest.mark.parametrize("window", [None, 6])
def test_decode_dispatch_with_alibi_and_window_matches_jax(monkeypatch, window):
    """Decode over a cache past the window, with ALiBi over grouped heads;
    only the bias- and window-free call reaches the decode kernel's
    wrapper."""
    import deepspeed_tpu.models.common as jcommon

    calls = []
    real = tcommon.decode_attention
    monkeypatch.setattr(tcommon, "decode_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rs = np.random.RandomState(7)
    q = rs.standard_normal((2, 6, 16)).astype(np.float32)
    kc, vc = (rs.standard_normal((2, 24, 3, 16)).astype(np.float32) for _ in range(2))
    slopes = tcommon.alibi_slopes(6)
    for alibi in (None, slopes):
        calls.clear()
        got = tcommon.cached_decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                                              torch.tensor(17, dtype=torch.int32), True,
                                              alibi=alibi, window=window)
        ref = jcommon.cached_decode_attention(
            *map(jnp.asarray, (q, kc, vc)), jnp.int32(17), False,
            alibi=None if alibi is None else jnp.asarray(alibi.numpy()),
            window=None if window is None else jnp.int32(window))
        _close(got, ref, 1e-5, f"alibi={alibi is not None} window={window}")
        assert len(calls) == int(alibi is None and window is None)
