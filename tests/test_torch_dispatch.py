"""Every head dim of the model presets reaches the kernel wrappers, on the
dense, decode and sparse paths, against the JAX package.

The port's kernels have instances for head dims 16, 32, 64, 80, 96 and 128,
which cover every preset (gpt2-tiny 32, gpt2-2.7b 80, llama-tiny 16); the
dense forward also has 40, 160 and 512, the head dims of SD-1.5's UNet and
VAE, and the dense forward and decode 256, GPT-J-6B's, where no path of the
port trains on the card. The wrappers raise for any other head dim on the
card, and the C dispatch of each kernel source takes its wrapper's list:
the forward's ``FWD_HEAD_DIMS``, the backward's, decode's and the
block-sparse kernels' ``HEAD_DIMS``. On the CPU a wrapper runs its plain
version, so each dispatch test replaces the wrapper the model code calls
with a probe that counts its calls and passes them on. The outputs are held
against the JAX functions on the same numpy inputs, in fp32 on the CPU,
where they differ only in summation order: 1e-5 (dense, decode), 1e-4
(sparse, as in tests/test_torch_sparse_attention.py).
"""

import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.models.common as jcommon
import deepspeed_tpu.ops.pallas.flash_attention as jfa
import deepspeed_tpu.ops.sparse_attention as jsa
from deepspeed_tpu_torch.models import common as tcommon
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.ops.pallas import decode_attention as tda
from deepspeed_tpu_torch.ops.pallas import flash_attention as tfa
from deepspeed_tpu_torch.ops import sparse_attention as tsa

HEAD_DIMS = (16, 32, 64, 80, 96, 128)                   # backward, block-sparse
DECODE_HEAD_DIMS = HEAD_DIMS + (256,)                   # decode: GPT-J-6B's too
FWD_HEAD_DIMS = (16, 32, 40, 64, 80, 96, 128, 160, 256, 512)   # the dense forward
CSRC = pathlib.Path(tfa.__file__).resolve().parents[2] / "csrc"
PRESETS = {**tgpt2.PRESETS, **tllama.PRESETS}
TOL = dict(atol=1e-5, rtol=1e-5)
SPARSE_TOL = dict(atol=1e-4, rtol=1e-4)


def _probe(monkeypatch, module, name):
    """Replace ``module.name`` by a pass-through that counts its calls."""
    calls = []
    real = getattr(module, name)

    def probe(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, probe)
    return calls


def _rand(*shapes, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_every_preset_head_dim_has_a_kernel_instance(preset):
    cfg = PRESETS[preset]
    head_dim = cfg.n_embd // cfg.n_head
    assert head_dim in tfa.HEAD_DIMS and head_dim in tda.HEAD_DIMS


def test_sd15_head_dims_have_forward_instances():
    """SD-1.5's UNet (8 heads on 320, 640 and 1280 channels), its VAE's
    single-head mid attention on 512 channels, CLIP ViT-L/14's text tower
    (12 heads on 768) and GPT-J-6B (16 heads on 4096) reach the forward
    kernel; the forward-only dims are exactly those the backward lacks."""
    from deepspeed_tpu_torch.models.diffusion import UNetConfig, VAEConfig

    unet = UNetConfig()
    dims = {c // unet.heads_for(i) for i, c in enumerate(unet.block_out_channels)}
    dims |= {VAEConfig().block_out_channels[-1], 768 // 12, 4096 // 16}
    assert dims == {40, 64, 80, 160, 256, 512} and dims <= set(tfa.FWD_HEAD_DIMS)
    assert set(tfa.FWD_HEAD_DIMS) - set(tfa.HEAD_DIMS) == dims - set(HEAD_DIMS)


@pytest.mark.parametrize("source,switch", [
    ("flash_attention_fwd.cu", "dispatch_d"), ("flash_attention_bwd.cu", "dispatch_d"),
    ("decode_attention.cu", "dispatch_dh"), ("sparse_attention.cu", "dispatch_d")])
def test_every_kernel_source_dispatches_the_wrappers_head_dims(source, switch):
    """The head-dim switch of each C entry has a case for exactly the head
    dims its wrapper lets through: the dense forward's FWD_HEAD_DIMS, every
    other kernel's HEAD_DIMS."""
    text = (CSRC / source).read_text()
    body = re.search(rf"\b{switch}\(.*?switch \(\w+\) \{{(.*?)\}}", text, re.S)
    assert body, f"no head-dim switch in {source}"
    cases = tuple(int(c) for c in re.findall(r"case (\d+):", body.group(1)))
    if source == "flash_attention_fwd.cu":
        assert cases == tfa.FWD_HEAD_DIMS == FWD_HEAD_DIMS
    elif source.startswith("decode"):
        assert cases == tda.HEAD_DIMS == DECODE_HEAD_DIMS
    else:
        assert cases == tfa.HEAD_DIMS == HEAD_DIMS


@pytest.mark.parametrize("head_dim", FWD_HEAD_DIMS)
def test_dense_attention_takes_the_kernel_for_every_head_dim(monkeypatch, head_dim):
    calls = _probe(monkeypatch, tcommon, "flash_attention")
    q, k, v = _rand(*[(2, 24, 2, head_dim)] * 3)
    out = tcommon.local_causal_attention(*map(torch.from_numpy, (q, k, v)), use_flash=True)
    assert len(calls) == 1
    ref = jcommon.local_causal_attention(*map(jnp.asarray, (q, k, v)), use_flash=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("head_dim", DECODE_HEAD_DIMS)
def test_decode_attention_takes_the_kernel_for_every_head_dim(monkeypatch, head_dim):
    calls = _probe(monkeypatch, tcommon, "decode_attention")
    q, k, v = _rand((2, 4, head_dim), (2, 40, 2, head_dim), (2, 40, 2, head_dim), seed=1)
    out = tcommon.cached_decode_attention(*map(torch.from_numpy, (q, k, v)), 29,
                                          use_flash_decode=True)
    assert len(calls) == 1
    ref = jcommon.cached_decode_attention(*map(jnp.asarray, (q, k, v)), jnp.int32(29))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_sparse_attention_takes_the_kernels_for_every_head_dim(monkeypatch, head_dim):
    """The JAX side runs its Pallas sparse kernel interpreted, which takes
    any head dim as its block."""
    if jax.default_backend() != "tpu":
        from jax.experimental import pallas as pl

        monkeypatch.setattr(jfa.pl, "pallas_call",
                            functools.partial(pl.pallas_call, interpret=True))
    calls = _probe(monkeypatch, tsa, "flash_attention_sparse")
    kw = dict(num_heads=2, block=32, num_local_blocks=2)
    q, k, v = _rand(*[(1, 128, 2, head_dim)] * 3, seed=2)
    out = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(**kw))(*map(torch.from_numpy,
                                                                      (q, k, v)))
    assert len(calls) == 1
    ref = jsa.SparseSelfAttention(jsa.FixedSparsityConfig(**kw))(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SPARSE_TOL)
