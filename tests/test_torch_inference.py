"""The port's inference engine against the JAX package's, on the CPU.

Greedy generation must give identical tokens; sampling is compared by its
filter rules (the two frameworks draw different random numbers). The
engine's decode loop over static buffers (``DecodeLoop``, the step a CUDA
graph captures on the card) runs eagerly here and must give the tokens of
the ungraphed loop (``build_generate_parts``) and of the JAX engine.
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
                                   {"dtype": "int8"}])
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


def _eager_loop(te, ids, max_new_tokens, seed=0, do_sample=False, temperature=1.0, top_k=0,
                top_p=1.0, eos_token_id=None):
    """The ungraphed decode loop of ``build_generate_parts`` on te's model."""
    prefill, decode = tengine.build_generate_parts(te.module, max_new_tokens, do_sample,
                                                   temperature, top_k, top_p, eos_token_id)
    ids = torch.from_numpy(np.asarray(ids)).long()
    with torch.inference_mode():
        logits, cache = prefill(ids)
        return decode(ids, logits, cache, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("use_flash_decode", [False, True])
@pytest.mark.parametrize("with_eos", [False, True])
def test_static_decode_loop_matches_eager_loop_and_jax(use_flash_decode, with_eos):
    """``generate`` runs the static-buffer step eagerly on the CPU: greedy
    tokens equal the ungraphed loop's and the JAX engine's, EOS masking
    included (a token row 0 emits mid-way)."""
    je, te = _engines(use_flash_decode)
    ids = _prompt()
    eos = int(np.asarray(je.generate(ids, max_new_tokens=8))[0, 10]) if with_eos else None
    out_j = np.asarray(je.generate(ids, max_new_tokens=8, eos_token_id=eos))
    out_t = te.generate(ids, max_new_tokens=8, eos_token_id=eos)
    assert torch.equal(out_t, _eager_loop(te, ids, 8, eos_token_id=eos))
    np.testing.assert_array_equal(out_t.numpy(), out_j)
    loop, = te._decode_loops.values()
    assert loop.graph is None                   # the CPU path captures nothing
    if with_eos:
        assert (out_t[0, 10:] == eos).all() and loop.done[0]


def test_second_generate_with_the_same_key_reuses_its_buffers():
    """A second call with the same key runs the same loop on the same
    buffers and gives the same tokens; other keys get loops of their own
    and do not disturb it."""
    _, te = _engines(False)
    ids = _prompt()
    first = te.generate(ids, max_new_tokens=8)
    loop, = te._decode_loops.values()
    buffers = {n: t.data_ptr() for n, t in loop.cache.items()}
    shorter = te.generate(ids, max_new_tokens=6)
    one_row = te.generate(ids[:1], max_new_tokens=8)
    eos = te.generate(ids, max_new_tokens=8, eos_token_id=int(first[0, 10]))
    again = te.generate(ids, max_new_tokens=8)
    assert len(te._decode_loops) == 4
    assert te._decode_loops[(2, 8, 8, False, 1.0, 0, 1.0, None)] is loop
    assert {n: t.data_ptr() for n, t in loop.cache.items()} == buffers
    assert torch.equal(again, first)
    assert torch.equal(shorter, _eager_loop(te, ids, 6))
    assert torch.equal(one_row, _eager_loop(te, ids[:1], 8))
    assert torch.equal(eos, _eager_loop(te, ids, 8, eos_token_id=int(first[0, 10])))


def test_engine_keeps_the_decode_loops_of_its_most_recent_keys():
    """Each loop holds a KV cache (and on the card a graph), so the engine
    keeps ``DECODE_LOOPS_KEPT`` of them: a new key drops the least recently
    used one, and that key comes back with a new loop and the same
    tokens."""
    _, te = _engines(False)
    ids = _prompt()
    key = lambda n: (2, 8, n, False, 1.0, 0, 1.0, None)
    kept = tengine.DECODE_LOOPS_KEPT
    first = te.generate(ids, max_new_tokens=2)
    loop = te._decode_loops[key(2)]
    for n in range(3, 2 + kept):
        te.generate(ids, max_new_tokens=n)
    te.generate(ids, max_new_tokens=2)          # key 2 is now the most recent
    te.generate(ids, max_new_tokens=2 + kept)   # one key too many: key 3 goes
    assert len(te._decode_loops) == kept and key(3) not in te._decode_loops
    assert te._decode_loops[key(2)] is loop
    assert torch.equal(te.generate(ids, max_new_tokens=3), _eager_loop(te, ids, 3))
    assert key(3) in te._decode_loops and key(4) not in te._decode_loops
    assert torch.equal(te.generate(ids, max_new_tokens=2), first)


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 50, 1.0), (0.7, 0, 0.9)])
def test_sampled_decode_loop_draws_the_eager_loops_stream(temperature, top_k, top_p):
    """The static loop's generator is reseeded per call, so a seed gives the
    draws of the ungraphed loop seeded alike, call after call."""
    _, te = _engines(False)
    ids = _prompt()
    kw = dict(do_sample=True, temperature=temperature, top_k=top_k, top_p=top_p)
    a = te.generate(ids, max_new_tokens=6, seed=3, **kw)
    b = te.generate(ids, max_new_tokens=6, seed=3, **kw)
    assert torch.equal(a, b) and torch.equal(a, _eager_loop(te, ids, 6, seed=3, **kw))
    assert torch.equal(te.generate(ids, max_new_tokens=6, seed=4, **kw),
                       _eager_loop(te, ids, 6, seed=4, **kw))


def test_enable_cuda_graph_is_accepted_as_in_jax():
    """The key the JAX config accepts as meaningless on TPU is accepted: the
    decode loop is one captured graph on the card whatever it says."""
    j = jconfig.DeepSpeedInferenceConfig(enable_cuda_graph=True)
    t = tconfig.DeepSpeedInferenceConfig.from_dict({"enable_cuda_graph": True})
    assert t.enable_cuda_graph is True and j.enable_cuda_graph is True
    model = tllama.LlamaModel(tllama.PRESETS["llama-tiny"])
    eng = deepspeed_tpu_torch.init_inference(model, {"dtype": "float32",
                                                     "enable_cuda_graph": True}, device="cpu")
    assert eng.generate(_prompt(), max_new_tokens=2).shape == (2, 10)
