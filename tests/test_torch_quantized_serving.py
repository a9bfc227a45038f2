"""int8 weight-quantized serving in the port against the JAX engine, on the
CPU (the quantizer itself: ``test_torch_quantizer.py``).

A tiny llama (its untied head quantized too) and a tiny gpt2, with the JAX
engine's weights copied across, through ``init_inference(dtype=int8)``:
logits at the bf16 limit (2e-2 of the largest) against the JAX engine with
``dtype`` int8 at the same ``quant`` block (8 bits; 4-bit codes are held to
JAX's in the quantizer's test), and greedy tokens and logits
identical to the port served in bf16 from the dequantized weights, at 8
and 4 bits (the tied llama too, whose embedding stays bf16). The engine
holds the codes and fewer bytes, no dequantized weight outlives the module
that used it, ``num_bits`` outside {4, 8} falls back to 8 with the JAX
warning, and ``dtype`` int8 with quantization disabled serves the bf16
weights with the JAX log line.
"""

import dataclasses
import gc
import logging
import weakref

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference import engine as tengine
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.ops import quantizer as tq
from deepspeed_tpu_torch.utils.logging import logger as tlogger

MIN_NUMEL = 1024          # the tiny models' projections are below the 1 << 16 default
BF16_LIMIT = 2e-2


def _quant(bits, enabled=True, weight_enabled=True):
    return {"enabled": enabled, "weight": {"enabled": weight_enabled, "num_bits": bits,
                                           "quantized_initialization": {"min_numel": MIN_NUMEL}}}


def _llama(tie):
    import jax

    from deepspeed_tpu.models import llama as jllama

    jcfg = dataclasses.replace(jllama.PRESETS["llama-tiny"], remat=False, tie_embeddings=tie)
    tcfg = dataclasses.replace(tllama.PRESETS["llama-tiny"], tie_embeddings=tie)
    jm = jllama.LlamaModel(jcfg)
    params = jm.init_params(jax.random.PRNGKey(1))
    return jm, params, lambda: tllama.params_from_jax(jax.tree.map(np.asarray, params), tcfg)


def _gpt2():
    import jax

    from deepspeed_tpu.models import gpt2 as jgpt2

    small = dict(vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=4)
    jm = jgpt2.GPT2Model(jgpt2.GPT2Config(**small, remat=False))
    params = jm.init_params(jax.random.PRNGKey(2))
    return jm, params, lambda: tgpt2.params_from_jax(jax.tree.map(np.asarray, params),
                                                     tgpt2.GPT2Config(**small))


MODELS = {"llama_tied": lambda: _llama(True), "llama_untied": lambda: _llama(False),
          "gpt2": _gpt2}
# (model, bits, held against the JAX engine)
CASES = [("llama_untied", 8, True), ("llama_untied", 4, False), ("gpt2", 8, True),
         ("gpt2", 4, False), ("llama_tied", 4, False)]


def _ids():
    return np.random.RandomState(5).randint(0, 256, size=(2, 8)).astype(np.int32)


@pytest.mark.parametrize("name,bits,jax_too", CASES)
def test_int8_serving_matches_jax_and_the_dequantized_model(name, bits, jax_too):
    jm, params, port_model = MODELS[name]()
    cfg = {"dtype": "int8", "quant": _quant(bits), "max_out_tokens": 64}
    te = deepspeed_tpu_torch.init_inference(port_model(), {**cfg, "dtype": torch.int8},
                                            device="cpu")
    assert te.dtype == torch.bfloat16 and te.quantized
    assert all(q.num_bits == bits for q in te.quantized.values())
    assert not any("wte" in n or "norm" in n or "ln" in n for n in te.quantized)
    assert ("lm_head" in te.quantized) == (name == "llama_untied")
    ids = _ids()
    if jax_too:
        import deepspeed_tpu
        from deepspeed_tpu.comm import comm

        comm.cdb = None
        je = deepspeed_tpu.init_inference(jm, config=dict(cfg), params=params)
        jl = np.asarray(je.forward(ids)).astype(np.float32)
        tl = te.forward(ids).float().numpy()
        assert np.abs(tl - jl).max() <= BF16_LIMIT * np.abs(jl).max()
    # the same model served in bf16 from the dequantized weights: the same tokens
    dq = tq.dequantize_params(te.quantized, torch.bfloat16)
    ref_model = port_model()
    ref = deepspeed_tpu_torch.init_inference(
        ref_model, {"dtype": "bf16", "max_out_tokens": 64}, device="cpu")
    with torch.no_grad():
        for n, w in dq.items():
            ref_model.get_parameter(n).copy_(w)
    out = te.generate(ids, max_new_tokens=8)
    assert torch.equal(out, ref.generate(ids, max_new_tokens=8))
    assert torch.equal(te.forward(ids), ref.forward(ids))
    held = te.weight_nbytes()
    assert held == ref.weight_nbytes() - sum(
        w.numel() * 2 for w in dq.values()) + sum(q.nbytes for q in te.quantized.values())
    assert held < ref.weight_nbytes()


def test_dequantized_weights_live_only_while_their_module_runs(monkeypatch):
    _, _, port_model = _llama(True)
    te = deepspeed_tpu_torch.init_inference(port_model(), {"dtype": torch.int8,
                                                           "quant": _quant(8)}, device="cpu")
    made = []
    real = tengine.dequantize_tensor

    def spy(leaf, dtype):
        out = real(leaf, dtype)
        made.append(out)
        return out

    monkeypatch.setattr(tengine, "dequantize_tensor", spy)
    assert all(te.module.get_parameter(n).is_meta for n in te.quantized)
    ids = torch.zeros(1, 4, dtype=torch.long)
    te.forward(ids)
    # each quantized weight dequantized once per forward, and none kept
    assert len(made) == len(te.quantized)
    refs = [weakref.ref(t) for t in made]
    made.clear()
    gc.collect()
    assert not any(r() is not None for r in refs)


def test_unsupported_bits_fall_back_to_8_and_disabled_quant_serves_bf16(caplog):
    _, _, port_model = _llama(True)
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    tlogger.addHandler(handler)
    try:
        te = deepspeed_tpu_torch.init_inference(port_model(), {"dtype": torch.int8,
                                                               "quant": _quant(6)},
                                                device="cpu")
        assert te.quantized and all(q.num_bits == 8 for q in te.quantized.values())
        assert any("num_bits=6 unsupported; using 8" in m for m in lines)
        assert any(m.endswith("(int8)") and "weight quantization:" in m for m in lines)
        for quant in (_quant(8, enabled=False), _quant(8, weight_enabled=False)):
            plain = deepspeed_tpu_torch.init_inference(port_model(), {"dtype": "int8",
                                                                      "quant": quant},
                                                       device="cpu")
            assert plain.quantized == {} and plain.dtype == torch.bfloat16
            assert plain.module.param_gatherer is None
        assert any("serving bf16 weights unquantized" in m for m in lines)
    finally:
        tlogger.removeHandler(handler)


def test_quant_config_parses_like_jax():
    from deepspeed_tpu.inference import config as jconfig

    from deepspeed_tpu_torch.inference import config as tconfig

    block = {"enabled": True, "weight": {"num_bits": 4, "q_type": "asymmetric", "q_groups": 2,
                                         "quantized_initialization": {"min_numel": 7}},
             "activation": {"enabled": False, "num_bits": 4}, "qkv": {"enabled": False}}
    for quant in ({}, block):
        j = jconfig.DeepSpeedInferenceConfig(dtype="int8", quant=quant).quant
        t = tconfig.DeepSpeedInferenceConfig.from_dict({"dtype": "int8", "quant": quant}).quant
        assert t.enabled == j.enabled and t.qkv.enabled == j.qkv.enabled
        for part in ("weight", "activation"):
            for f in ("enabled", "num_bits", "q_type", "q_groups"):
                assert getattr(getattr(t, part), f) == getattr(getattr(j, part), f), (part, f)
        assert t.weight.quantized_initialization == j.weight.quantized_initialization
    with pytest.raises(ValueError, match="did you mean 'num_bits'"):
        tconfig.DeepSpeedInferenceConfig.from_dict({"quant": {"weight": {"num_bit": 4}}})
