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
it), fp32 1e-4 (summation order). The bf16 and fp16 instances of the
flash forward, the dense dk/dv and the block-sparse dq and dk/dv run on the
tensor cores and round P (and dS) to the input type before the second
products, as the JAX kernels do; the fp32 instances keep the CUDA-core code.
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


GRAD_TOL = {torch.bfloat16: 1e-2, torch.float16: 2.5e-3}


def _flash_fwd_and_dkv(gen, BH, t_q, t_k, D, dtype, causal):
    """The tensor-core forward and dk/dv kernels against their plain versions
    in fp32 on the same inputs. → (dk, dv)."""
    q, do = (torch.randn(BH, t_q, D, generator=gen, device="cuda") for _ in range(2))
    k, v = (torch.randn(BH, t_k, D, generator=gen, device="cuda") for _ in range(2))
    q, k, v, do = (q * D ** -0.5).to(dtype), k.to(dtype), v.to(dtype), do.to(dtype)
    o, lse = tfa.flash_forward(q, k, v, causal)
    o_ref, lse_ref = tfa.mha_reference_lse(q.float(), k.float(), v.float(), causal)
    assert torch.isfinite(o).all()
    assert (o.float() - o_ref).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = tfa.flash_backward_dkv(q, k, v, do, lse, delta, causal)
    refs = tfa.mha_backward_dkv_reference(q.float(), k.float(), v.float(), do.float(), lse,
                                          delta, causal)
    for name, g, r in zip(("dk", "dv"), (dk, dv), refs):
        err = (g.float() - r).abs().max().item()
        assert torch.isfinite(g).all() and err <= GRAD_TOL[dtype] * max(1.0, r.abs().max().item()), \
            (name, err)
    return dk, dv


@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 200, 1000])
def test_tensor_core_kernels_at_tile_edges(gen, T):
    """Ragged and whole 64-row tiles, causal, bf16, head dim 96."""
    _flash_fwd_and_dkv(gen, 16, T, T, 96, torch.bfloat16, True)


@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tensor_core_kernels_per_head_dim_and_type(gen, D, dtype):
    _flash_fwd_and_dkv(gen, 8, 200, 200, D, dtype, True)


def test_tensor_core_kernels_noncausal_with_more_keys_than_queries(gen):
    _flash_fwd_and_dkv(gen, 8, 100, 300, 96, torch.bfloat16, False)


def test_causal_keys_no_query_sees_get_exact_zeros(gen):
    """Top-left causal with Tq=64 < Tk=200: keys 64.. are seen by no query,
    and their dk and dv are exactly 0."""
    dk, dv = _flash_fwd_and_dkv(gen, 8, 64, 200, 96, torch.bfloat16, True)
    assert torch.count_nonzero(dk[:, 64:]).item() == 0
    assert torch.count_nonzero(dv[:, 64:]).item() == 0
    assert torch.count_nonzero(dv[:, :64]).item() > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tensor_core_kernels_repeat_bitwise(gen, dtype):
    """One owner per output and a fixed order of sums: two calls on the same
    inputs give the same bits."""
    q, k, v, do = (torch.randn(16, 333, 96, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    o, lse = tfa.flash_forward(q, k, v, True)
    o2, lse2 = tfa.flash_forward(q, k, v, True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = tfa.flash_backward_dkv(q, k, v, do, lse, delta, True)
    dk2, dv2 = tfa.flash_backward_dkv(q, k, v, do, lse, delta, True)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


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


SPARSE_GRAD_TOL = {**GRAD_TOL, torch.float32: 1e-4}


def _sparse_backward(gen, lay, T, D, dtype, causal, BH=4):
    """The sparse forward, dq and dk/dv kernels on one set of inputs, each
    backward output against its plain version in fp32. → (dq, dk, dv,
    inputs)."""
    q, k, v, do = (torch.randn(BH, T, D, generator=gen, device="cuda") for _ in range(4))
    q, k, v, do = (q * D ** -0.5).to(dtype), k.to(dtype), v.to(dtype), do.to(dtype)
    o, lse = tfa.sparse_forward(q, k, v, lay, causal)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    dq = tfa.sparse_backward_dq(*args, lay, causal)
    dk, dv = tfa.sparse_backward_dkv(*args, lay, causal)
    torch.cuda.synchronize()
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    refs = (tfa.sparse_backward_dq_reference(q32, k32, v32, do32, lse, delta, lay, causal),
            *tfa.sparse_backward_dkv_reference(q32, k32, v32, do32, lse, delta, lay, causal))
    for name, g, r in zip("qkv", (dq, dk, dv), refs):
        err = (g.float() - r).abs().max().item()
        assert torch.isfinite(g).all() and \
            err <= SPARSE_GRAD_TOL[dtype] * max(1.0, r.abs().max().item()), (name, err)
    return dq, dk, dv, args


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_sparse_tensor_core_backward_matches_plain(gen, block, D, dtype, causal):
    """The tensor-core dq and dk/dv over their CTA schedules: eight layout
    blocks of the fixed layout (causal) or BigBird (not causal)."""
    T = 8 * block
    cfg = FixedSparsityConfig(4, block=block, num_local_blocks=4) if causal \
        else BigBirdSparsityConfig(4, block=block)
    before = dict(tfa.SPARSE_KERNEL.entry_launches)
    _sparse_backward(gen, cfg.make_layout(T), T, D, dtype, causal)
    after = tfa.SPARSE_KERNEL.entry_launches
    assert (after["sparse_attention_bwd_dq"] - before["sparse_attention_bwd_dq"],
            after["sparse_attention_bwd_dkv"] - before["sparse_attention_bwd_dkv"]) == (1, 1)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sparse_backward_warps_of_one_cta_with_disjoint_lists(gen, dtype, causal):
    """Each query block attends only itself: the four warps of a CTA walk
    four different chunks, none shared."""
    n = 16
    lay = np.eye(n, dtype=bool)
    pairs = tfa.sparse_pairs(lay, causal, 16 * n, "cuda")
    assert all(bin(int(m)).count("1") == 1 for m in pairs.dq.masks)
    _sparse_backward(gen, lay, 16 * n, 64, dtype, causal)


@pytest.mark.parametrize("block,dtype", [(16, torch.float16), (32, torch.bfloat16),
                                         (128, torch.bfloat16), (16, torch.float32)])
def test_sparse_unattended_keys_per_block_and_type(gen, block, dtype):
    """Odd key blocks attended by no query: exact zeros in dk and dv, from
    CTAs that walk no chunk and from warps whose bits are all clear."""
    n = 8
    lay = np.zeros((n, n), dtype=bool)
    lay[:, 0] = True
    lay[np.arange(0, n, 2), np.arange(0, n, 2)] = True
    T = n * block
    _, dk, dv, _ = _sparse_backward(gen, lay, T, 96, dtype, True)
    odd = torch.arange(T, device="cuda").view(n, block)[1::2].flatten()
    assert torch.count_nonzero(dk[:, odd]).item() == 0
    assert torch.count_nonzero(dv[:, odd]).item() == 0
    assert torch.count_nonzero(dv[:, :block]).item() > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_sparse_backward_repeats_bitwise(gen, dtype):
    """One owner per output row and a fixed order of sums: repeated calls
    give the same bits."""
    T = 512
    lay = FixedSparsityConfig(4, block=16, num_local_blocks=4).make_layout(T)
    dq, dk, dv, args = _sparse_backward(gen, lay, T, 128, dtype, True)
    assert torch.equal(dq, tfa.sparse_backward_dq(*args, lay, True))
    dk2, dv2 = tfa.sparse_backward_dkv(*args, lay, True)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("block,D,causal", [(16, 128, True), (128, 96, True), (32, 64, False)])
def test_sparse_fp32_backward_on_the_cuda_cores(gen, block, D, causal):
    T = 8 * block
    cfg = FixedSparsityConfig(4, block=block, num_local_blocks=4) if causal \
        else BigBirdSparsityConfig(4, block=block)
    _sparse_backward(gen, cfg.make_layout(T), T, D, torch.float32, causal)


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
