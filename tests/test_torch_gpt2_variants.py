"""The GPT-2 variant switches of the port against the JAX package.

Each switch alone (ALiBi, rotary in both conventions, the parallel
residual, ReLU, GPT-Neo's local window, the head bias) and the combinations
the families use (GPT-NeoX/Pythia, GPT-J, BLOOM, OPT, GPT-Neo), at 2 layers
and narrow widths: the JAX ``init_params`` draws the weights (no ``wpe``
under ALiBi or rotary), ``params_from_jax`` copies them, and the same numpy
tokens go into both: ``apply``, ``loss`` and every gradient (the serving
walk is ``test_torch_gpt2_variants_serving.py``). Both
sides compute in fp32 on the CPU through their plain attention and differ
in summation order only: logits and loss within 1e-5 of the largest
reference value, gradients within 1e-4 of each tensor's largest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import common as tcommon
from deepspeed_tpu_torch.models import gpt2 as tgpt2

BASE = dict(vocab_size=256, n_positions=64, n_embd=96, n_layer=2, n_head=6)
VARIANTS = {
    "alibi": dict(alibi=True),
    "rotary_half": dict(rotary_pct=0.25),
    "rotary_interleaved": dict(rotary_pct=0.5, rotary_interleaved=True),
    "parallel_residual": dict(parallel_residual=True),
    "relu": dict(activation="relu"),
    "local_window": dict(attention_layers=("local", "global"), window_size=8),
    "head_bias": dict(tie_embeddings=False, lm_head_bias=True),
    "gpt_neox": dict(rotary_pct=0.25, parallel_residual=True, tie_embeddings=False,
                     activation="gelu"),
    "gptj": dict(rotary_pct=0.5, rotary_interleaved=True, parallel_residual=True,
                 tie_embeddings=False, lm_head_bias=True),
    "bloom": dict(alibi=True, embed_layernorm=True),
    "opt": dict(activation="relu"),
    "gpt_neo": dict(attention_layers=("global", "local"), window_size=8),
}
B, T, STEPS = 2, 12, 8


def _configs(name, **over):
    kw = {**BASE, **VARIANTS[name], **over}
    return (jgpt2.GPT2Config(**kw, dtype=jnp.float32, remat=False),
            tgpt2.GPT2Config(**kw, dtype=torch.float32, remat=False))


def _params(jcfg, seed):
    params = jgpt2.GPT2Model(jcfg).init_params(jax.random.PRNGKey(seed))
    if "lm_head_b" in params:        # zeros at init; a drawn bias is checked too
        params["lm_head_b"] = 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 1),
                                                      params["lm_head_b"].shape)
    return jax.tree.map(np.asarray, params)


def _ids(seed, t=T):
    return np.random.RandomState(seed).randint(0, BASE["vocab_size"], (B, t)).astype(np.int32)


def _close(got, ref, rel, what=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, f"{what}: max err {err} over {rel} x {scale}"


def test_every_variant_keeps_the_jax_param_keys():
    for name in VARIANTS:
        jcfg, tcfg = _configs(name)
        params = _params(jcfg, 0)
        model = tgpt2.params_from_jax(params, tcfg)
        top = {n for n, _ in model.named_parameters() if not n.startswith("blocks.")}
        assert top == set(params) - {"blocks"}, name
        assert ("wpe" in top) == model.learned_positions


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_apply_loss_and_grads_match_jax(name):
    jcfg, tcfg = _configs(name)
    params = _params(jcfg, 1)
    ids = _ids(1)
    jmodel = jgpt2.GPT2Model(jcfg)
    model = tgpt2.params_from_jax(params, tcfg)
    with torch.no_grad():
        _close(model.apply(torch.from_numpy(ids)), jax.jit(jmodel.apply)(params, jnp.asarray(ids)),
               1e-5, "logits")
    batch = {"input_ids": ids}
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jmodel.loss(p, batch)))(params)
    loss = model.loss({"input_ids": torch.from_numpy(ids)})
    loss.backward()
    _close(loss.detach(), jloss, 1e-5, "loss")
    for n, p in model.named_parameters():
        if n.startswith("blocks."):
            _, layer, key = n.split(".")
            ref = jgrads["blocks"][key][int(layer)]
        else:
            ref = jgrads[n]
        _close(p.grad, ref, 1e-4, n)


def test_alibi_slopes_match_jax_for_every_head_count():
    from deepspeed_tpu.models.common import alibi_slopes

    for n in (1, 2, 3, 5, 6, 8, 12, 16, 24, 32, 40, 112):
        np.testing.assert_array_equal(tcommon.alibi_slopes(n).numpy(),
                                      np.asarray(alibi_slopes(n)), err_msg=str(n))


@pytest.mark.parametrize("interleaved", [False, True])
def test_rope_conventions_match_jax(interleaved):
    import deepspeed_tpu.models.common as jcommon

    x = np.random.RandomState(3).standard_normal((2, 7, 3, 8)).astype(np.float32)
    pos = np.arange(7)
    jcos, jsin = jcommon._rope_cos_sin(jnp.asarray(pos), 8, 10000.0, interleaved=interleaved)
    tcos, tsin = tcommon._rope_cos_sin(torch.from_numpy(pos), 8, 10000.0,
                                       interleaved=interleaved)
    _close(tcos, jcos, 1e-6, "cos")
    _close(tsin, jsin, 1e-6, "sin")
    _close(tcommon.apply_rope(torch.from_numpy(x), tcos, tsin, interleaved),
           jcommon.apply_rope(jnp.asarray(x), jcos, jsin, interleaved), 1e-6, "rotated")


@pytest.mark.parametrize("window", [None, 0, 5])
def test_attention_dispatch_takes_the_kernel_only_without_bias_or_window(monkeypatch,
                                                                         window):
    """The kernel wrapper runs for a global layer (no window, or a window
    <= 0), the plain masked attention for ALiBi or a window > 0, as the JAX
    dispatch sends those to the einsum; both held to JAX."""
    import deepspeed_tpu.models.common as jcommon

    calls = []
    real = tcommon.flash_attention
    monkeypatch.setattr(tcommon, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    q, k, v = (np.random.RandomState(s).standard_normal((2, 16, 4, 16)).astype(np.float32)
               for s in (4, 5, 6))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    slopes = tcommon.alibi_slopes(4)
    for alibi in (None, slopes):
        calls.clear()
        got = tcommon.local_causal_attention(tq, tk, tv, True, alibi=alibi, window=window)
        ref = jcommon.local_causal_attention(
            *map(jnp.asarray, (q, k, v)), True,
            alibi=None if alibi is None else jnp.asarray(alibi.numpy()),
            window=None if window is None else jnp.int32(window))
        _close(got, ref, 1e-5, f"alibi={alibi is not None} window={window}")
        assert len(calls) == int(alibi is None and not window)


def test_sequence_parallel_still_raises_and_windows_are_checked():
    with pytest.raises(NotImplementedError):
        tgpt2.GPT2Config(**BASE, sequence_parallel="ulysses")
    for bad in (dict(attention_layers=("local", "sliding")),
                dict(attention_layers=("local", "global"), window_size=0)):
        with pytest.raises(ValueError):
            jgpt2.GPT2Config(**BASE, **bad)
        with pytest.raises(ValueError):
            tgpt2.GPT2Config(**BASE, **bad)
    cfg = tgpt2.GPT2Config(**BASE, flash_block=128)
    assert cfg.flash_block == 128 and dataclasses.replace(cfg).flash_block == 128
