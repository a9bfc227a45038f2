"""The port's llama model against the JAX package's, on the CPU.

Same weights (JAX's init, copied with params_from_jax), same numpy inputs.
Both sides run in fp32 on the CPU (the JAX model takes its einsum attention
path off the TPU; the port's wrappers run their plain versions), so the
differences are summation order only: logits and cache at atol = rtol =
1e-4, RoPE tables at 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import common as jcommon
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.models import common as tcommon
from deepspeed_tpu_torch.models import llama as tllama

TOL = dict(atol=1e-4, rtol=1e-4)
LLAMA3_ROPE = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}
VARIANTS = {
    "gqa": {},
    # tied embeddings and llama3 RoPE scaling, as llama3.2-1b has them
    "tied_llama3_rope": {"tie_embeddings": True, "rope_theta": 500000.0,
                         "rope_scaling": LLAMA3_ROPE},
}


def _pair(variant, use_flash_decode=False):
    kw = VARIANTS[variant]
    jcfg = dataclasses.replace(jllama.PRESETS["llama-tiny"], dtype=jnp.float32, remat=False,
                               use_flash_decode=use_flash_decode, **kw)
    tcfg = dataclasses.replace(tllama.PRESETS["llama-tiny"], dtype=torch.float32,
                               use_flash_decode=use_flash_decode, **kw)
    jm = jllama.LlamaModel(jcfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    tm = tllama.params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    return jm, params, tm


def _ids(B, T, seed=0):
    return np.random.RandomState(seed).randint(0, 512, size=(B, T)).astype(np.int32)


def test_params_from_jax_is_exact():
    jm, params, tm = _pair("gqa")
    np_params = jax.tree.map(np.asarray, params)
    sd = tm.state_dict()
    assert sd["wte"].dtype == torch.float32
    np.testing.assert_array_equal(sd["wte"].numpy(), np_params["wte"])
    np.testing.assert_array_equal(sd["lm_head"].numpy(), np_params["lm_head"])
    np.testing.assert_array_equal(sd["norm_g"].numpy(), np_params["norm_g"])
    for key in tllama.BLOCK_KEYS:
        for n in range(jm.config.n_layer):
            np.testing.assert_array_equal(sd[f"blocks.{n}.{key}"].numpy(),
                                          np_params["blocks"][key][n])
    assert len(sd) == 3 + len(tllama.BLOCK_KEYS) * jm.config.n_layer


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_logits_and_cache_match(variant):
    jm, params, tm = _pair(variant)
    ids = _ids(2, 8)
    lj, cj = jm.prefill(params, jnp.asarray(ids), jm.init_cache(2, 16))
    with torch.inference_mode():
        lt, ct = tm.prefill(torch.from_numpy(ids).long(), tm.init_cache(2, 16))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["k"]), **TOL)
    np.testing.assert_allclose(ct["v"].numpy(), np.asarray(cj["v"]), **TOL)
    assert int(ct["pos"]) == int(cj["pos"]) == 8


@pytest.mark.parametrize("use_flash_decode", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_steps_match(variant, use_flash_decode):
    jm, params, tm = _pair(variant, use_flash_decode)
    ids = _ids(2, 8, seed=1)
    lj, cj = jm.prefill(params, jnp.asarray(ids), jm.init_cache(2, 16))
    with torch.inference_mode():
        lt, ct = tm.prefill(torch.from_numpy(ids).long(), tm.init_cache(2, 16))
        for _ in range(3):
            tok = np.argmax(np.asarray(lj), axis=-1).astype(np.int32)
            lj, cj = jm.decode_step(params, jnp.asarray(tok), cj)
            lt, ct = tm.decode_step(torch.from_numpy(tok).long(), ct)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["k"]), **TOL)
    assert int(ct["pos"]) == int(cj["pos"]) == 11


def test_full_forward_matches():
    jm, params, tm = _pair("tied_llama3_rope")
    ids = _ids(2, 12, seed=2)
    with torch.inference_mode():
        out = tm.apply(torch.from_numpy(ids).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.apply(params, jnp.asarray(ids))), **TOL)


@pytest.mark.parametrize("scaling", [None, {"rope_type": "linear", "factor": 4.0}, LLAMA3_ROPE])
@pytest.mark.parametrize("head_dim,theta", [(16, 10000.0), (64, 500000.0)])
def test_rope_tables_match(scaling, head_dim, theta):
    pos = np.arange(128, dtype=np.int32)
    cj, sj = jcommon._rope_cos_sin(jnp.asarray(pos), head_dim, theta, scaling)
    ct, st = tcommon._rope_cos_sin(torch.from_numpy(pos), head_dim, theta, scaling)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5, rtol=0)


def test_model_holds_no_weights_until_given_them():
    m = tllama.LlamaModel(tllama.PRESETS["llama-tiny"])
    assert all(p.is_meta for p in m.parameters())
    m.init_params(torch.Generator().manual_seed(0))
    assert not any(p.is_meta for p in m.parameters())
    assert m.blocks[0].q_w.shape == (64, 64) and m.blocks[0].k_w.shape == (64, 32)
