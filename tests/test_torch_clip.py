"""The port's CLIP text encoder against the JAX package and transformers.

The JAX ``CLIPTextEncoder`` (a GPT-2 trunk with quick-GELU) and the port's
get the same weights (numpy draws on the JAX tree, carried across by
``params_from_jax``) and the same ids; both run in fp32 on the CPU, the
port's causal attention through the flash kernel's plain version, so they
differ only in summation order (1e-5 of the largest value). A tiny
``transformers.CLIPTextModel`` loads through the port's ``load_clip_text``
and is held to HF's own outputs within 2e-3, as tests/unit/test_diffusion.py
holds the JAX loader. JAX is imported inside the test functions.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import clip as tclip
from deepspeed_tpu_torch.models.gpt2 import GPT2Config
from deepspeed_tpu_torch.module_inject import hf as thf

TINY = dict(vocab_size=128, n_positions=32, n_embd=64, n_layer=2, n_head=4,
            activation="quick_gelu", remat=False)
RTOL = 1e-5


def _pair(eos_token_id=None, seed=0):
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.models import clip as jclip
    from deepspeed_tpu.models.gpt2 import GPT2Config as JConfig

    jm = jclip.CLIPTextEncoder(JConfig(**TINY, dtype=jnp.float32, use_flash_attention=False),
                               eos_token_id=eos_token_id)
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda s: (0.2 * rs.standard_normal(s.shape)).astype(np.float32), shapes)
    tm = tclip.params_from_jax(params, GPT2Config(**TINY, dtype=torch.float32),
                               eos_token_id=eos_token_id)
    return jm, params, tm


def _ids(seed=1, eos=None):
    ids = np.random.RandomState(seed).randint(4, 120, size=(3, 16)).astype(np.int64)
    if eos is not None:          # two end tokens in a row: the first one counts
        ids[:, 5:] = np.random.RandomState(seed).randint(4, 120, size=(3, 11))
        ids[0, 9:11] = ids[1, 3:5] = ids[2, 15] = eos
    return ids


def _close(out, ref, rtol=RTOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= rtol * np.abs(ref).max()


@pytest.mark.parametrize("eos", [None, 3], ids=["argmax_eot", "first_eos"])
def test_apply_and_pooled_match_jax(eos):
    import jax

    jm, params, tm = _pair(eos_token_id=eos)
    ids = _ids(eos=eos)
    with torch.no_grad():
        hidden = tm.apply(torch.from_numpy(ids))
        pooled = tm.pooled(torch.from_numpy(ids))
    _close(hidden.numpy(), jax.jit(jm.apply)(params, ids))
    _close(pooled.numpy(), jax.jit(jm.pooled)(params, ids))
    eot = ids.argmax(-1) if eos is None else (ids == eos).argmax(-1)
    np.testing.assert_array_equal(pooled.numpy(), hidden.numpy()[np.arange(3), eot])


def test_loss_raises_like_jax():
    _, _, tm = _pair()
    with pytest.raises(NotImplementedError, match="conditioning tower"):
        tm.loss({"input_ids": torch.zeros(1, 4, dtype=torch.long)})


@pytest.fixture(scope="module")
def hf_clip():
    from transformers import CLIPTextConfig, CLIPTextModel

    torch.manual_seed(0)
    # the port's GPT-2 MLP is 4 x hidden wide, as CLIP ViT-L/14's text tower is
    cfg = CLIPTextConfig(vocab_size=128, hidden_size=64, intermediate_size=256,
                         num_hidden_layers=2, num_attention_heads=4,
                         max_position_embeddings=32, eos_token_id=3)
    return CLIPTextModel(cfg).eval()


def test_load_clip_text_matches_transformers(hf_clip):
    config, sd = thf.load_clip_text(hf_clip)
    assert (config.n_layer, config.n_head, config.activation) == (2, 4, "quick_gelu")
    model, sd2 = thf.load_hf_model(hf_clip)           # model_type "clip_text_model"
    assert type(model) is tclip.CLIPTextEncoder and model.eos_token_id == 3
    assert sd2.keys() == sd.keys()
    model.load_state_dict(sd, assign=True)
    ids = _ids(seed=2, eos=3)
    with torch.no_grad():
        ours = model.apply(torch.from_numpy(ids))
        pooled = model.pooled(torch.from_numpy(ids))
        theirs = hf_clip(torch.from_numpy(ids))
    torch.testing.assert_close(ours, theirs.last_hidden_state, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(pooled, theirs.pooler_output, rtol=2e-3, atol=2e-3)


def test_load_clip_text_equals_the_jax_loader(hf_clip):
    """The port's state dict is the JAX loader's tree, per layer, exactly."""
    from deepspeed_tpu.module_inject import hf as jhf

    jconfig, jparams = jhf.load_clip_text(hf_clip)
    config, sd = thf.load_clip_text(hf_clip)
    ref = tclip.params_from_jax(jparams, GPT2Config(**{**TINY, "dtype": torch.float32}),
                                eos_token_id=jconfig._clip_eos_token_id).state_dict()
    assert sd.keys() == ref.keys()
    assert all(torch.equal(sd[k], ref[k]) for k in sd)
    assert config._clip_eos_token_id == jconfig._clip_eos_token_id == 3


def test_init_inference_serves_the_hidden_states(hf_clip):
    model, sd = thf.load_hf_model(hf_clip)
    engine = deepspeed_tpu_torch.init_inference(model, config={"dtype": "float32"}, params=sd,
                                                device="cpu")
    ids = _ids(seed=3)
    out = engine.forward(ids.astype(np.int32))
    with torch.no_grad():
        ref = hf_clip(torch.from_numpy(ids)).last_hidden_state
    assert out.shape == (3, 16, 64)
    torch.testing.assert_close(out, ref, rtol=2e-3, atol=2e-3)
