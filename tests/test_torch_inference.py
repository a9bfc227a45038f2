"""The port's inference engine against the JAX package's, on the CPU.

Greedy generation must give identical tokens; sampling is compared by its
filter rules (the two frameworks draw different random numbers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm import comm
from deepspeed_tpu.inference import config as jconfig
from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.inference import config as tconfig
from deepspeed_tpu_torch.inference import engine as tengine
from deepspeed_tpu_torch.models import llama as tllama

SAMPLING = [  # (temperature, top_k, top_p)
    (0.7, 5, 1.0),
    (1.0, 0, 0.9),
    (1.3, 10, 0.8),
    (1.0, 0, 1e-6),
]


def _engines(use_flash_decode):
    jcfg = dataclasses.replace(jllama.PRESETS["llama-tiny"], dtype=jnp.float32, remat=False,
                               use_flash_decode=use_flash_decode)
    tcfg = dataclasses.replace(tllama.PRESETS["llama-tiny"], dtype=torch.float32,
                               use_flash_decode=use_flash_decode)
    jm = jllama.LlamaModel(jcfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    comm.cdb = None
    je = deepspeed_tpu.init_inference(jm, config={"dtype": "float32", "max_out_tokens": 64},
                                      params=params)
    te = deepspeed_tpu_torch.init_inference(
        tllama.params_from_jax(jax.tree.map(np.asarray, params), tcfg),
        {"dtype": "float32", "max_tokens": 64}, device="cpu")
    return je, te


def _prompt():
    return np.random.RandomState(0).randint(0, 512, size=(2, 8)).astype(np.int32)


@pytest.mark.parametrize("use_flash_decode", [False, True])
def test_greedy_generate_tokens_identical(use_flash_decode):
    je, te = _engines(use_flash_decode)
    ids = _prompt()
    out_j = np.asarray(je.generate(ids, max_new_tokens=8))
    out_t = te.generate(ids, max_new_tokens=8)
    assert out_t.shape == (2, 16)
    np.testing.assert_array_equal(out_t.numpy(), out_j)
    np.testing.assert_allclose(te.forward(ids).numpy(), np.asarray(je.forward(ids)),
                               atol=1e-4, rtol=1e-4)


def test_eos_masking_matches():
    je, te = _engines(False)
    ids = _prompt()
    free = np.asarray(je.generate(ids, max_new_tokens=8))
    eos = int(free[0, 10])                       # a token row 0 emits mid-way
    out_j = np.asarray(je.generate(ids, max_new_tokens=8, eos_token_id=eos))
    out_t = te.generate(ids, max_new_tokens=8, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(out_t, out_j)
    assert (out_t[0, 10:] == eos).all()


@pytest.mark.parametrize("temperature,top_k,top_p", SAMPLING)
def test_sampling_filter_keeps_the_same_tokens(monkeypatch, temperature, top_k, top_p):
    logits = np.random.RandomState(1).standard_normal((3, 64)).astype(np.float32) * 3
    seen = []

    def capture(rng, filtered, axis=-1):
        seen.append(np.asarray(filtered))
        return jnp.zeros(filtered.shape[:-1], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jengine._sample(jnp.asarray(logits), jax.random.PRNGKey(0), temperature, top_k, top_p,
                    greedy=False)
    filtered = tengine._filter_logits(torch.from_numpy(logits), temperature, top_k, top_p)
    kept_j, kept_t = seen[0] > -1e29, filtered.numpy() > -1e29
    np.testing.assert_array_equal(kept_t, kept_j)
    np.testing.assert_allclose(filtered.numpy()[kept_t], seen[0][kept_j], rtol=1e-6)


@pytest.mark.parametrize("top_k,top_p", [(1, 1.0), (0, 1e-6)])
def test_top1_filters_reproduce_greedy(top_k, top_p):
    logits = torch.from_numpy(np.random.RandomState(2).standard_normal((4, 64)).astype(np.float32))
    greedy = tengine._sample(logits, None, 1.0, 0, 1.0, greedy=True)
    for seed in range(3):
        drawn = tengine._sample(logits, torch.Generator().manual_seed(seed), 1.0, top_k, top_p,
                                greedy=False)
        assert torch.equal(drawn, greedy)


def test_sampled_generate_follows_the_seed():
    _, te = _engines(False)
    ids = _prompt()
    kw = dict(max_new_tokens=6, do_sample=True, temperature=1.0)
    a, b = te.generate(ids, seed=1, **kw), te.generate(ids, seed=1, **kw)
    c = te.generate(ids, seed=2, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_config_takes_the_jax_keys_and_rejects_unknown_ones():
    j_keys = jconfig.DeepSpeedInferenceConfig._accepted_keys()
    fields = dataclasses.fields(tconfig.DeepSpeedInferenceConfig)
    t_keys = {f.name for f in fields} | {f.metadata["alias"] for f in fields
                                         if "alias" in f.metadata}
    assert t_keys == j_keys
    cfg = tconfig.DeepSpeedInferenceConfig.from_dict(
        {"kernel_inject": True, "tp": {"tp_size": 1}, "max_tokens": 64, "dtype": "auto"})
    assert cfg.replace_with_kernel_inject and cfg.max_out_tokens == 64
    assert cfg.tp_size == 1 and cfg.torch_dtype() == torch.bfloat16
    with pytest.raises(ValueError, match="did you mean 'dtype'"):
        tconfig.DeepSpeedInferenceConfig.from_dict({"dtyp": "bf16"})
    with pytest.raises(ValueError, match="tp_sise"):
        tconfig.DeepSpeedInferenceConfig.from_dict({"tp": {"tp_sise": 1}})


@pytest.mark.parametrize("block", [{"tp": {"tp_size": 2}}, {"mp_size": 2},
                                   {"moe": {"ep_size": 2}}, {"quant": {"enabled": True}},
                                   {"dtype": "int8"}, {"enable_cuda_graph": True}])
def test_config_blocks_of_later_slices_raise(block):
    with pytest.raises(NotImplementedError, match="later slice"):
        tconfig.DeepSpeedInferenceConfig.from_dict(block)


def test_init_inference_without_cuda_raises_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the no-card refusal is what is tested")
    model = tllama.LlamaModel(tllama.PRESETS["llama-tiny"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.init_inference(model, {"dtype": "float32"})
    eng = deepspeed_tpu_torch.init_inference(model, {"dtype": "float32"}, device="cpu")
    assert eng.device.type == "cpu" and eng.module.wte.dtype == torch.float32
