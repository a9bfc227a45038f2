"""The port's GPT-2 serving path against the JAX package.

A 2-layer GPT-2 with the JAX package's weights copied exactly
(``params_from_jax``) serves the same numpy prompt on both sides: the KV
cache's shapes, prefill's last-position logits and the cache it fills, 8
``decode_step``s with the decode kernel on and off (the JAX decode kernel
interprets itself off the TPU), and greedy ``generate`` through both
engines. The JAX prefill runs its Pallas flash kernel interpreted, as
``tests/unit/test_flash_attention.py`` runs it (its own dispatch takes the
einsum path off the TPU); the port's wrappers run their plain versions on
these CPU tensors. Tolerances: fp32 2e-5 (summation order); bf16 2e-2 (the
compute type's rounding, carried through two layers). A sparse-attention
config refuses a cache on both sides, with the same message.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.models.common as jcommon
import deepspeed_tpu.ops.pallas.flash_attention as jfa
import deepspeed_tpu_torch
from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2

SMALL = dict(vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=2, remat=False)
B, PROMPT, STEPS, CACHE = 2, 16, 8, 32
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def jax_flash(monkeypatch):
    """The JAX prefill's attention through its Pallas flash kernel,
    interpreted on the CPU."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(jfa.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))

    def flash_local(q, k, v, use_flash=True, alibi=None, window=None, **kw):
        assert use_flash and alibi is None and window is None and not kw
        return jfa.flash_attention(q, k, v, causal=True)

    monkeypatch.setattr(jcommon, "local_causal_attention", flash_local)


def _models(dtype="float32", use_flash_decode=False, **over):
    jd, td = DTYPES[dtype]
    kw = {**SMALL, "use_flash_decode": use_flash_decode, **over}
    jcfg, tcfg = jgpt2.GPT2Config(**kw, dtype=jd), tgpt2.GPT2Config(**kw, dtype=td)
    params = jgpt2.GPT2Model(dataclasses.replace(jcfg, dtype=jnp.float32)).init_params(
        jax.random.PRNGKey(3))
    np_params = jax.tree.map(np.asarray, params)
    tmodel = tgpt2.params_from_jax(np_params, tcfg)
    return jgpt2.GPT2Model(jcfg), params, tmodel


def _prompt():
    return np.random.RandomState(0).randint(0, SMALL["vocab_size"], size=(B, PROMPT)) \
        .astype(np.int32)


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not torch.is_tensor(a) \
        else a.float().numpy()


def _close(got, ref, dtype, what):
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(ref), rtol=tol, atol=tol, err_msg=what)


def test_init_cache_matches_jax():
    jm, _, tm = _models()
    jc, tc = jm.init_cache(B, CACHE), tm.init_cache(B, CACHE)
    assert set(tc) == set(jc) == {"k", "v", "pos"}
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape == (2, B, CACHE, 2, 32)
        assert tc[key].dtype == torch.float32 and not tc[key].any()
    assert tc["pos"].shape == () and tc["pos"].dtype == torch.int32 and int(tc["pos"]) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(jax_flash, dtype):
    jm, params, tm = _models(dtype)
    ids = _prompt()
    j_logits, j_cache = jm.prefill(params, jnp.asarray(ids), jm.init_cache(B, CACHE))
    with torch.inference_mode():
        t_logits, t_cache = tm.prefill(torch.from_numpy(ids).long(), tm.init_cache(B, CACHE))
    assert tuple(t_logits.shape) == (B, SMALL["vocab_size"]) and t_logits.dtype == torch.float32
    _close(t_logits, j_logits, dtype, "prefill logits")
    for key in ("k", "v"):
        _close(t_cache[key][:, :, :PROMPT], j_cache[key][:, :, :PROMPT], dtype, key)
        assert not t_cache[key][:, :, PROMPT:].any()
    assert int(t_cache["pos"]) == int(j_cache["pos"]) == PROMPT


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_flash_decode", [False, True])
def test_decode_steps_match_jax(dtype, use_flash_decode):
    """8 steps from the same prefill state; both sides take the JAX side's
    greedy token, so a near tie cannot send them down different paths."""
    jm, params, tm = _models(dtype, use_flash_decode)
    ids = _prompt()
    j_logits, j_cache = jm.prefill(params, jnp.asarray(ids), jm.init_cache(B, CACHE))
    j_step = jax.jit(jm.decode_step)
    with torch.inference_mode():
        _, t_cache = tm.prefill(torch.from_numpy(ids).long(), tm.init_cache(B, CACHE))
        for step in range(STEPS):
            tok = np.asarray(jnp.argmax(j_logits, axis=-1)).astype(np.int32)
            j_logits, j_cache = j_step(params, jnp.asarray(tok), j_cache)
            t_logits, t_cache = tm.decode_step(torch.from_numpy(tok).long(), t_cache)
            _close(t_logits, j_logits, dtype, f"decode step {step}")
    end = PROMPT + STEPS
    for key in ("k", "v"):
        _close(t_cache[key][:, :, :end], j_cache[key][:, :, :end], dtype, key)
    assert int(t_cache["pos"]) == int(j_cache["pos"]) == end


@pytest.mark.parametrize("use_flash_decode", [False, True])
def test_greedy_generate_identical_to_jax_engine(use_flash_decode):
    jm, params, tm = _models("float32", use_flash_decode)
    jcomm.cdb = None
    je = deepspeed_tpu.init_inference(jm, config={"dtype": "float32", "max_out_tokens": 64},
                                      params=params)
    te = deepspeed_tpu_torch.init_inference(tm, {"dtype": "float32", "max_tokens": 64},
                                            device="cpu")
    ids = _prompt()
    out_j = np.asarray(je.generate(ids, max_new_tokens=STEPS))
    out_t = te.generate(ids, max_new_tokens=STEPS)
    assert tuple(out_t.shape) == (B, PROMPT + STEPS)
    np.testing.assert_array_equal(out_t.numpy(), out_j)


def test_sparse_config_refuses_a_cache_like_jax():
    block = {"mode": "fixed", "block": 16}
    jm, _, tm = _models(sparse_attention=block)
    with pytest.raises(NotImplementedError) as j_err:
        jm.init_cache(B, CACHE)
    with pytest.raises(NotImplementedError) as t_err:
        tm.init_cache(B, CACHE)
    assert str(t_err.value) == str(j_err.value)
