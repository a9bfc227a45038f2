"""The port's CUDA kernels and engine on the card.

Every test here is ``cuda``-marked and skips without a CUDA device. The
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch; there, without the repository's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: kernel against its plain version in fp32 on the same inputs; a
bf16 output carries its own rounding (2e-2), fp32 outputs and the LSE only
summation order (1e-4, LSE 1e-3).
"""

import dataclasses

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.llama import PRESETS, LlamaModel
from deepspeed_tpu_torch.ops.pallas import decode_attention as tda
from deepspeed_tpu_torch.ops.pallas import flash_attention as tfa

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("T,causal,dtype,tol", [
    (128, True, torch.bfloat16, 2e-2), (100, True, torch.float32, 1e-4),
    (128, False, torch.bfloat16, 2e-2), (1, True, torch.bfloat16, 2e-2)])
def test_flash_kernel_matches_plain(gen, T, causal, dtype, tol):
    q, k, v = (torch.randn(64, T, 64, generator=gen, device="cuda") for _ in range(3))
    q, k, v = (q * 0.125).to(dtype), k.to(dtype), v.to(dtype)
    before = tfa.KERNEL.launches
    o, lse = tfa.flash_forward(q, k, v, causal)
    o_ref, lse_ref = tfa.mha_reference_lse(q.float(), k.float(), v.float(), causal)
    assert tfa.KERNEL.launches == before + 1
    assert (o.float() - o_ref).abs().max().item() <= tol
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("kv,pos,dtype,tol", [
    (8, 255, torch.bfloat16, 2e-2), (1, 0, torch.bfloat16, 2e-2),
    (32, 130, torch.float32, 1e-4)])
def test_decode_kernel_matches_plain(gen, kv, pos, dtype, tol):
    q = torch.randn(4, 32, 64, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(4, 256, kv, 64, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    ref = tda.decode_reference(q.float(), k.float(), v.float(), pos)
    v[:, pos + 1:] = float("nan")            # past pos: never read
    out = tda.decode_attention(q, k, v, torch.tensor(pos, dtype=torch.int32, device="cuda"))
    assert (out.float() - ref).abs().max().item() <= tol


def test_kernel_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    q = torch.randn(2, 16, 32, generator=gen, device="cuda")      # head dim 32
    with pytest.raises(ValueError):
        tfa.flash_forward(q, q, q)
    with pytest.raises(ValueError):
        tda.decode_attention(q, q[:, :, None], q[:, :, None], 3)


def test_generate_kernel_path_matches_plain_path(gen):
    """fp32, head dim 64: greedy tokens of the kernel path equal the plain
    path's, and every layer launched each kernel."""
    cfg = dataclasses.replace(PRESETS["llama-tiny"], n_embd=256, n_head=4, n_kv_head=2,
                              intermediate_size=512, dtype=torch.float32,
                              use_flash_decode=True)
    model = LlamaModel(cfg).init_params(gen)
    plain = LlamaModel(dataclasses.replace(cfg, use_flash_attention=False,
                                           use_flash_decode=False))
    eng = deepspeed_tpu_torch.init_inference(model, {"dtype": "float32"})
    eng_p = deepspeed_tpu_torch.init_inference(plain, {"dtype": "float32"},
                                               params=model.state_dict())
    ids = torch.randint(0, cfg.vocab_size, (3, 20), generator=gen, device="cuda")
    fa0, da0 = tfa.KERNEL.launches, tda.KERNEL.launches
    out = eng.generate(ids, max_new_tokens=12)
    assert (tfa.KERNEL.launches - fa0, tda.KERNEL.launches - da0) == (2, 2 * 12)
    assert torch.equal(out, eng_p.generate(ids, max_new_tokens=12))
