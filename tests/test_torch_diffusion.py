"""The port's stable-diffusion UNet and VAE against the JAX package.

Tiny configurations as in tests/unit/test_diffusion.py. The weights are
numpy draws (a seed) on the JAX model's own tree, carried across by
``params_from_jax``; the inputs are numpy draws too. On the CPU the port's
attention runs the flash kernel's plain version and the JAX side its einsum
path; both compute in fp32 and differ only in summation order, so the
outputs are held to 1e-4 of their largest value. The loaders, the diffusers
``_class_name`` dispatch and ``InferenceEngine.forward(sample, timestep,
context)`` on ``device="cpu"`` are checked here too. JAX is imported inside
the test functions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import diffusion as td
from deepspeed_tpu_torch.module_inject import hf as thf

TINY_UNET = dict(in_channels=4, out_channels=4, block_out_channels=(32, 64),
                 layers_per_block=1,
                 down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                 cross_attention_dim=48, attention_head_dim=8, norm_num_groups=8)
TINY_VAE = dict(in_channels=3, out_channels=3, latent_channels=4, block_out_channels=(16, 32),
                layers_per_block=1, norm_num_groups=8)
RTOL = 1e-4      # of the largest |value|: fp32 on both sides, summation order only


def _jax_tree(jmodel, seed):
    """The JAX model's parameter tree (``init_params``'s structure) filled
    with numpy normal draws over sqrt(fan in)."""
    import jax

    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: (rs.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[1:]) or 1.0))
        .astype(np.float32), shapes)


def _unet_pair(seed=0, **over):
    from deepspeed_tpu.models import diffusion as jd

    jm = jd.UNet2DConditionModel(jd.UNetConfig(**{**TINY_UNET, **over}))
    params = _jax_tree(jm, seed)
    return jm, params, td.params_from_jax(params, td.UNetConfig(**{**TINY_UNET, **over}))


def _vae_pair(seed=0):
    from deepspeed_tpu.models import diffusion as jd

    jm = jd.AutoencoderKL(jd.VAEConfig(**TINY_VAE))
    params = _jax_tree(jm, seed)
    return jm, params, td.params_from_jax(params, td.VAEConfig(**TINY_VAE))


def _unet_inputs(seed=1, batch=2):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((batch, 4, 16, 16)).astype(np.float32),
            np.asarray([3, 500][:batch]),
            rs.standard_normal((batch, 7, 48)).astype(np.float32))


def _close(out, ref, rtol=RTOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref).max()
    assert err <= rtol * np.abs(ref).max(), (err, np.abs(ref).max())


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("over", [{}, {"use_linear_projection": True},
                                  {"attention_head_dim": (4, 8)}],
                         ids=["conv_proj", "linear_proj", "per_block_heads"])
def test_unet_matches_jax(over):
    import jax

    jm, params, tm = _unet_pair(**over)
    x, t, ctx = _unet_inputs()
    ref = jax.jit(jm.apply)(params, x, t, ctx)
    with torch.no_grad():
        out = tm.apply(*_t(x, t, ctx))
    _close(out.numpy(), ref)
    # the projections are the kind the config asks for, told apart by rank
    proj = tm["down_blocks"]["0"]["attentions"]["0"]["proj_in"]["weight"]
    assert proj.dim() == (2 if over.get("use_linear_projection") else 4)


def test_unet_head_counts_and_checks():
    cfg = td.UNetConfig(**{**TINY_UNET, "attention_head_dim": (4, 8)})
    assert (cfg.heads_for(0), cfg.heads_for(1)) == (4, 8)
    with pytest.raises(ValueError, match="per-block"):
        dataclasses.replace(cfg, attention_head_dim=(4, 8, 16))
    with pytest.raises(NotImplementedError, match="down block"):
        td.UNetConfig(**{**TINY_UNET, "down_block_types": ("SimpleDown", "DownBlock2D")})
    # SD-1.5's defaults: 8 heads of 40, 80 and 160 channels, the sizes of the
    # JAX defaults
    from deepspeed_tpu.models import diffusion as jd

    assert dataclasses.asdict(td.UNetConfig())["block_out_channels"] == \
        jd.UNetConfig().block_out_channels
    assert [c // td.UNetConfig().heads_for(i) for i, c in
            enumerate(td.UNetConfig().block_out_channels)] == [40, 80, 160, 160]


def test_unet_timestep_and_context_change_the_output():
    _, _, tm = _unet_pair(seed=2)
    x, t, ctx = _t(*_unet_inputs(seed=3))
    with torch.no_grad():
        out = tm.apply(x, t, ctx)
        out_t = tm.apply(x, torch.tensor([900, 10]), ctx)
        out_c = tm.apply(x, t, ctx * 2.0)
        out_0d = tm.apply(x[:1], torch.tensor(3), ctx[:1])
    assert out.shape == (2, 4, 16, 16)
    assert (out - out_t).abs().max() > 1e-6        # the time embedding is live
    assert (out - out_c).abs().max() > 1e-6        # the cross-attention is live
    torch.testing.assert_close(out_0d, out[:1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fn", ["encode", "decode", "apply"])
def test_vae_matches_jax(fn):
    import jax

    jm, params, tm = _vae_pair()
    rs = np.random.RandomState(4)
    x = rs.standard_normal((2, 3, 16, 16) if fn != "decode" else (2, 4, 8, 8)) \
        .astype(np.float32)
    ref = jax.jit(lambda p, x: getattr(jm, fn)(p, x))(params, x)
    with torch.no_grad():
        out = getattr(tm, fn)(torch.from_numpy(x))
    want = {"encode": (2, 4, 8, 8), "decode": (2, 3, 16, 16), "apply": (2, 3, 16, 16)}[fn]
    assert tuple(out.shape) == want
    _close(out.numpy(), ref)


def test_state_dict_keys_are_the_diffusers_keys():
    unet = td.UNet2DConditionModel(td.UNetConfig(**TINY_UNET))
    vae = td.AutoencoderKL(td.VAEConfig(**TINY_VAE))
    keys = set(unet.state_dict())
    assert "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight" in keys
    assert "time_embedding.linear_1.weight" in keys and "mid_block.resnets.1.conv2.bias" in keys
    assert {"encoder.mid_block.attentions.0.to_q.weight", "quant_conv.weight",
            "decoder.up_blocks.0.upsamplers.0.conv.weight"} <= set(vae.state_dict())
    assert all(p.is_meta for p in unet.parameters())           # until filled
    unet.init_params(torch.Generator().manual_seed(0))
    w = unet["conv_in"]["weight"]
    assert not w.is_meta and w.shape == (32, 4, 3, 3)
    assert torch.equal(unet["conv_norm_out"]["weight"], torch.ones(32))
    assert float(w.detach().std()) == pytest.approx(1 / 6, rel=0.2)   # 1 / sqrt(4 * 3 * 3)


@pytest.mark.parametrize("kind", ["unet", "vae"])
def test_loaders_from_the_flat_export_equal_params_from_jax(kind):
    from deepspeed_tpu.module_inject import hf as jhf

    _, params, tm = (_unet_pair if kind == "unet" else _vae_pair)(seed=5)
    flat = thf.export_vision_params(params)
    assert set(flat) == set(tm.state_dict())
    assert set(flat) == set(jhf.export_vision_params(params))
    cfg = td.UNetConfig(**TINY_UNET) if kind == "unet" else td.VAEConfig(**TINY_VAE)
    loader = thf.load_unet if kind == "unet" else thf.load_vae
    cfg2, sd = loader(flat, config=cfg)
    model = (td.UNet2DConditionModel if kind == "unet" else td.AutoencoderKL)(cfg2)
    model.load_state_dict(sd, assign=True)
    ref = tm.state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in model.state_dict().items())
    # and back: the port's model exports the same flat dict
    back = thf.export_vision_params(model)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)


def _fake_diffusers(class_name, cfg, sd):
    class Fake:
        config = type("Config", (), {"_class_name": class_name,
                                      **dataclasses.asdict(cfg)})

        @staticmethod
        def state_dict():
            return sd

    return Fake()


def test_load_hf_model_dispatches_the_diffusers_class_name():
    _, _, unet = _unet_pair(seed=6)
    _, _, vae = _vae_pair(seed=7)
    for name, ref, cls in (("UNet2DConditionModel", unet, td.UNet2DConditionModel),
                           ("AutoencoderKL", vae, td.AutoencoderKL)):
        cfg = dataclasses.replace(ref.config)
        model, sd = thf.load_hf_model(_fake_diffusers(name, cfg, ref.state_dict()))
        assert type(model) is cls
        assert dataclasses.asdict(model.config) == dataclasses.asdict(ref.config)
        model.load_state_dict(sd, assign=True)
        assert all(torch.equal(v, ref.state_dict()[k]) for k, v in model.state_dict().items())
    # llama, BERT and DistilBERT load now, and need the HF config's head
    # count; an architecture the port does not load raises
    for arch in ("llama", "bert", "distilbert"):
        with pytest.raises(ValueError, match="bare state dict"):
            thf.load_hf_model({"w": np.zeros(2)}, architecture=arch)
    with pytest.raises(NotImplementedError, match="loading architecture None"):
        thf.load_hf_model({"w": np.zeros(2)}, architecture=None)


def test_engine_forward_serves_the_unet_with_float_inputs():
    """The diffusers surface: engine.forward(sample, timestep, context) is
    module.apply on the same inputs (floats kept, the timestep an integer)."""
    _, _, tm = _unet_pair(seed=8)
    x, t, ctx = _unet_inputs(seed=9)
    engine = deepspeed_tpu_torch.init_inference(tm, config={"dtype": "float32"},
                                                device="cpu")
    out = engine.forward(x, t, ctx)
    with torch.no_grad():
        ref = tm.apply(*_t(x, t, ctx))
    assert out.dtype == torch.float32 and not out.requires_grad
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    # a float timestep and torch inputs take the same path
    torch.testing.assert_close(engine(*_t(x, t.astype(np.float32), ctx)), ref, rtol=0, atol=0)


def test_engine_forward_keeps_a_float_image():
    """A VAE's float image goes to apply unrounded (an integer cast would
    change the output)."""
    _, _, vae = _vae_pair(seed=10)
    img = np.random.RandomState(11).uniform(-1, 1, (1, 3, 16, 16)).astype(np.float32)
    engine = deepspeed_tpu_torch.init_inference(vae, config={"dtype": "float32"},
                                                device="cpu")
    out = engine.forward(img)
    with torch.no_grad():
        ref = vae.apply(torch.from_numpy(img))
        rounded = vae.apply(torch.from_numpy(img).long().float())
    assert out.shape == (1, 3, 16, 16)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert (out - rounded).abs().max() > 1e-3


def test_engine_forward_of_a_random_unet_in_bf16():
    """No weights given: seed-0 random weights, cast to the serving type;
    the model's own compute type then takes the inputs."""
    cfg = td.UNetConfig(**{**TINY_UNET, "dtype": torch.bfloat16})
    engine = deepspeed_tpu_torch.init_inference(td.UNet2DConditionModel(cfg),
                                                config={"dtype": "bf16"}, device="cpu")
    x, t, ctx = _unet_inputs(seed=12)
    out = engine.forward(x, t, ctx)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 4, 16, 16)
    assert torch.isfinite(out.float()).all()
    assert all(p.dtype == torch.bfloat16 for p in engine.module.parameters())
