"""The port's CUDA kernels and engine on the card.

Every test here is ``cuda``-marked and skips without a CUDA device. The
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch; there, without the repository's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: kernel against its plain version in fp32 on the same inputs; a
bf16 output carries its own rounding (2e-2), fp32 outputs and the LSE only
summation order (1e-4, LSE 1e-3). Backward gradients are held relative to
the largest reference gradient, floored at 1 for these unit-normal inputs:
bf16 1e-2 and fp16 2.5e-3 (the outputs' own rounding is 2^-9 and 2^-11 of
it), fp32 1e-4 (summation order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.models.llama import PRESETS, LlamaModel
from deepspeed_tpu_torch.ops.pallas import decode_attention as tda
from deepspeed_tpu_torch.ops.pallas import flash_attention as tfa
from deepspeed_tpu_torch.ops.sparse_attention import (BigBirdSparsityConfig,
                                                      FixedSparsityConfig)

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


@pytest.mark.parametrize("BH,T,D,causal,dtype,tol", [
    (32, 200, 96, True, torch.bfloat16, 1e-2), (16, 128, 64, False, torch.float32, 1e-4),
    (8, 77, 128, True, torch.float32, 1e-4), (16, 130, 64, True, torch.float16, 2.5e-3)])
def test_flash_backward_kernels_match_plain(gen, BH, T, D, causal, dtype, tol):
    q, k, v, do = (torch.randn(BH, T, D, generator=gen, device="cuda") for _ in range(4))
    q, k, v, do = (q * D ** -0.5).to(dtype), k.to(dtype), v.to(dtype), do.to(dtype)
    o, lse = tfa.flash_forward(q, k, v, causal)
    before = dict(tfa.BWD_KERNEL.entry_launches)
    got = tfa.flash_backward(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    delta = (do.float() * o.float()).sum(-1)
    ref = tfa.mha_backward_reference(q.float(), k.float(), v.float(), do.float(), lse, delta,
                                     causal)
    assert {n: tfa.BWD_KERNEL.entry_launches[n] - before[n] for n in before} == {
        "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1}
    for name, g, r in zip("qkv", got, ref):
        err = (g.float() - r).abs().max().item()
        assert torch.isfinite(g).all() and err <= tol * max(1.0, r.abs().max().item()), \
            (name, err)


@pytest.mark.parametrize("dtype,precision", [
    (torch.bfloat16, {"bf16": {"enabled": True}}),
    (torch.float16, {"fp16": {"enabled": True, "initial_scale_power": 8}})])
def test_train_batch_runs_the_kernels(gen, dtype, precision):
    """One bf16 or fp16 step of a 2-layer GPT-2 (head dim 64) through
    initialize → train_batch: each layer launches the forward and both
    backward kernels once, and the step changes the weights."""
    cfg = gpt2.GPT2Config(vocab_size=1024, n_positions=128, n_embd=256, n_layer=2, n_head=4,
                          remat=False, dtype=dtype)
    engine, *_ = deepspeed_tpu_torch.initialize(model=gpt2.GPT2Model(cfg), config={
        "train_batch_size": 4, "gradient_clipping": 1.0, **precision,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, "steps_per_print": 0})
    batch = gpt2.synthetic_lm_batch(4, 128, cfg.vocab_size, device="cuda")
    before_w = engine.module.blocks[0].qkv_w.detach().clone()
    tfa.KERNEL.reset_launches()
    tfa.BWD_KERNEL.reset_launches()
    loss = engine.train_batch(batch)
    assert torch.isfinite(loss) and engine.global_steps == 1
    assert (tfa.KERNEL.launches, tfa.BWD_KERNEL.entry_launches["flash_attention_bwd_dq"],
            tfa.BWD_KERNEL.entry_launches["flash_attention_bwd_dkv"]) == (2, 2, 2)
    assert not torch.equal(before_w, engine.module.blocks[0].qkv_w)
    assert engine.module.wte.dtype == dtype and engine.master[0].dtype == torch.float32
    assert engine.skipped_steps == 0


@pytest.mark.parametrize("T,block,D,causal,dtype,tol,gtol", [
    (512, 16, 128, True, torch.bfloat16, 2e-2, 1e-2),
    (256, 64, 64, False, torch.float32, 1e-4, 1e-4)])
def test_sparse_kernels_match_plain(gen, T, block, D, causal, dtype, tol, gtol):
    """Forward, dq and dk/dv of the block-sparse kernels against their plain
    versions in fp32 on the same inputs; each entry launches once."""
    cfg = FixedSparsityConfig(4, block=block, num_local_blocks=4) if causal \
        else BigBirdSparsityConfig(4, block=block)
    lay = cfg.make_layout(T)
    q, k, v, do = (torch.randn(8, T, D, generator=gen, device="cuda") for _ in range(4))
    q, k, v, do = (q * D ** -0.5).to(dtype), k.to(dtype), v.to(dtype), do.to(dtype)
    before = dict(tfa.SPARSE_KERNEL.entry_launches)
    o, lse = tfa.sparse_forward(q, k, v, lay, causal)
    delta = (do.float() * o.float()).sum(-1)
    dq = tfa.sparse_backward_dq(q, k, v, do, lse, delta, lay, causal)
    dk, dv = tfa.sparse_backward_dkv(q, k, v, do, lse, delta, lay, causal)
    torch.cuda.synchronize()
    assert {n: tfa.SPARSE_KERNEL.entry_launches[n] - before[n] for n in before} == dict.fromkeys(
        before, 1)
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    o_ref, lse_ref = tfa.sparse_reference_lse(q32, k32, v32, lay, causal)
    assert (o.float() - o_ref).abs().max().item() <= tol
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    refs = (tfa.sparse_backward_dq_reference(q32, k32, v32, do32, lse, delta, lay, causal),
            *tfa.sparse_backward_dkv_reference(q32, k32, v32, do32, lse, delta, lay, causal))
    for name, g, r in zip("qkv", (dq, dk, dv), refs):
        err = (g.float() - r).abs().max().item()
        assert torch.isfinite(g).all() and err <= gtol * max(1.0, r.abs().max().item()), \
            (name, err)


def test_sparse_unattended_key_block_gets_exactly_zero(gen):
    """A key block no query attends: its dk and dv are written as zeros."""
    T, n = 256, 16
    lay = np.zeros((n, n), dtype=bool)
    lay[:, 0] = True
    lay[np.arange(0, n, 2), np.arange(0, n, 2)] = True   # odd key blocks: no query
    q, k, v, do = (torch.randn(4, T, 64, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    o, lse = tfa.sparse_forward(q, k, v, lay)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = tfa.sparse_backward_dkv(q, k, v, do, lse, delta, lay)
    odd = torch.arange(T, device="cuda").view(n, 16)[1::2].flatten()
    assert torch.count_nonzero(dk[:, odd]).item() == 0
    assert torch.count_nonzero(dv[:, odd]).item() == 0
    assert torch.count_nonzero(dv[:, :16]).item() > 0


def test_sparse_train_batch_runs_the_kernels(gen):
    """One bf16 step of a 2-layer GPT-2 (head dim 64) with the ds_config
    sparse_attention block: each layer launches each sparse kernel once and
    no dense flash kernel."""
    cfg = gpt2.GPT2Config(vocab_size=1024, n_positions=256, n_embd=256, n_layer=2, n_head=4,
                          remat=False, dtype=torch.bfloat16)
    engine, *_ = deepspeed_tpu_torch.initialize(model=gpt2.GPT2Model(cfg), config={
        "train_batch_size": 2, "bf16": {"enabled": True}, "steps_per_print": 0,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
        "sparse_attention": {"mode": "fixed", "block": 16, "num_local_blocks": 4}})
    batch = gpt2.synthetic_lm_batch(2, 256, cfg.vocab_size, device="cuda")
    for kern in (tfa.KERNEL, tfa.BWD_KERNEL, tfa.SPARSE_KERNEL):
        kern.reset_launches()
    loss = engine.train_batch(batch)
    assert torch.isfinite(loss) and engine.global_steps == 1
    assert tfa.SPARSE_KERNEL.entry_launches == dict.fromkeys(tfa.SPARSE_KERNEL.entry_launches, 2)
    assert tfa.KERNEL.launches == tfa.BWD_KERNEL.launches == 0
