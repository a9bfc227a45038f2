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
flash forward, the dense dq and dk/dv, the block-sparse forward, dq and
dk/dv and decode run on the tensor cores and round P (and dS) to the input
type before the second products, as the JAX kernels do; the fp32 instances
keep the CUDA-core code. Decode splits the cache over CTAs; the engine's
decode loop is a captured CUDA graph, held here against the eager loop.
Every kernel has instances for head dims 16, 32, 64, 80, 96 and 128, the
head dims of the model presets. The last tests feed a small bf16 GPT-2
through its data loader, save and resume it (the state after a load equal
to the saved state bit for bit, the losses equal to the uninterrupted
run's) and run the seqlen curriculum through the kernels at ragged lengths.
The ZeRO tests train it over a NCCL process group of one (the card's
machine has one card, and NCCL takes no two ranks on one device) at stages
0–3: the same losses (bf16 1%, fp32 1e-5) and kernel launches at every
stage, and a tag saved at stage 3 restored bit for bit at stage 1. The
offload tests keep the optimizer state (and the params) in pinned host
memory: every host tensor is pinned, the streamed and whole-state updates
give the in-card update's losses and params bit for bit (the same
elementwise ops on the same values), and the aio handle reads a swap file
straight into a pinned tensor.
"""

import dataclasses
import os

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


@pytest.mark.parametrize("D", [16, 32, 80])
@pytest.mark.parametrize("causal", [True, False])
def test_fp32_flash_forward_per_head_dim(gen, D, causal):
    """The CUDA-core forward at the head dims of the tiny and 2.7b presets;
    at 16 and 80 the upper lanes own no column of the last group of 32."""
    q, k, v = (torch.randn(16, 130, D, generator=gen, device="cuda") for _ in range(3))
    q = q * D ** -0.5
    before = tfa.KERNEL.launches
    o, lse = tfa.flash_forward(q, k, v, causal)
    o_ref, lse_ref = tfa.mha_reference_lse(q, k, v, causal)
    assert tfa.KERNEL.launches == before + 1
    assert (o - o_ref).abs().max().item() <= 1e-4
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("kv,pos,dtype,tol", [
    (8, 255, torch.bfloat16, 2e-2), (1, 0, torch.bfloat16, 2e-2),
    (32, 130, torch.float32, 1e-4), (8, 200, torch.float16, 2e-2), (1, 0, torch.float16, 2e-2)])
def test_decode_kernel_matches_plain(gen, kv, pos, dtype, tol):
    _decode_checked(gen, kv, pos, dtype, tol, 64)


def _decode_checked(gen, kv, pos, dtype, tol, dh):
    """The decode kernel against its plain version in fp32 on the same
    inputs, with NaN in the cache past ``pos``; one launch."""
    q = torch.randn(4, 32, dh, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(4, 256, kv, dh, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    ref = tda.decode_reference(q.float(), k.float(), v.float(), pos)
    v[:, pos + 1:] = float("nan")            # past pos: never read
    before = tda.KERNEL.launches
    out = tda.decode_attention(q, k, v, torch.tensor(pos, dtype=torch.int32, device="cuda"))
    assert tda.KERNEL.launches == before + 1
    assert (out.float() - ref).abs().max().item() <= min(tol, 2e-2 * ref.abs().max().item())


@pytest.mark.parametrize("dh", [16, 32, 80])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)])
def test_decode_kernel_per_head_dim(gen, dh, dtype, tol):
    """The head dims of the tiny and 2.7b presets; at 16 and 80 the upper
    lanes own no column of the last group of 32."""
    _decode_checked(gen, 8, 200, dtype, tol, dh)


@pytest.mark.parametrize("B,S,kv,at", [
    (4, 8192, 8, "end"), (4, 8192, 8, "chunk_last"), (4, 8192, 8, "chunk_first"),
    (4, 8192, 8, 0), (1, 32768, 8, 20000), (4, 8192, 1, 5000)])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float16, 2e-2),
                                       (torch.float32, 1e-4)])
def test_split_decode_kernel_long_caches_and_chunk_edges(gen, B, S, kv, at, dtype, tol):
    """The split kernel over long caches (8 chunks of 1024 at B=4, S=8192 on
    132 SMs): pos at the end, at a chunk's last and first entry, at 0 (one
    chunk holds the only key), most chunks past pos, MQA; NaN past pos is
    never read. The kernel against the plain version, and the split's plain
    version against the plain one."""
    chunk = tda.decode_chunk(B, kv, S, torch.cuda.get_device_properties(0).multi_processor_count)
    pos = {"end": S - 1, "chunk_last": chunk - 1, "chunk_first": chunk}.get(at, at)
    assert -(-S // chunk) > 1                    # these caches take the merge
    q = torch.randn(B, 32, 64, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(B, S, kv, 64, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    ref = tda.decode_reference(q.float(), k.float(), v.float(), pos)
    split = tda.decode_split_reference(q.float(), k.float(), v.float(), pos, chunk)
    v[:, pos + 1:] = float("nan")
    before = tda.KERNEL.launches
    out = tda.decode_attention(q, k, v, torch.tensor(pos, dtype=torch.int32, device="cuda"))
    assert tda.KERNEL.launches == before + 1
    # softmax over N unit-normal values keeps |ref| ~ sqrt(e / N): the limit
    # is also held to 2e-2 of the reference's largest value
    assert (out.float() - ref).abs().max().item() <= min(tol, 2e-2 * ref.abs().max().item())
    assert (split - ref).abs().max().item() <= 1e-4


def _graph_engine(gen, dtype=torch.float32, n_layer=2):
    cfg = dataclasses.replace(PRESETS["llama-tiny"], n_embd=256, n_head=4, n_kv_head=2,
                              n_layer=n_layer, intermediate_size=512, dtype=dtype,
                              use_flash_decode=True)
    model = LlamaModel(cfg).init_params(gen)
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    return deepspeed_tpu_torch.init_inference(model, {"dtype": name, "max_out_tokens": 256})


def _eager_loop(eng, ids, max_new_tokens, seed=0, **sample):
    from deepspeed_tpu_torch.inference.engine import build_generate_parts

    prefill, decode = build_generate_parts(eng.module, max_new_tokens,
                                           sample.get("do_sample", False),
                                           sample.get("temperature", 1.0),
                                           sample.get("top_k", 0), 1.0, None)
    with torch.inference_mode():
        logits, cache = prefill(ids)
        return decode(ids, logits, cache, torch.Generator(device="cuda").manual_seed(seed))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generate_replays_a_captured_decode_graph(gen, dtype):
    """2-layer llama: generate captures the decode step once and replays it;
    greedy tokens equal the eager loop's; the decode kernel's launches read
    layers x (new tokens + the warm-up step) on the first call and layers x
    new tokens on the second, which replays the same graph without
    capturing again; a cache of 200 entries (4 chunks) takes the merge."""
    eng = _graph_engine(gen, dtype)
    ids = torch.randint(0, 512, (3, 120), generator=gen, device="cuda")
    counts = []
    for _ in range(2):
        fa0, da0 = tfa.KERNEL.launches, tda.KERNEL.launches
        out = eng.generate(ids, max_new_tokens=80)
        counts.append((tfa.KERNEL.launches - fa0, tda.KERNEL.launches - da0))
        if len(counts) == 1:
            loop, = eng._decode_loops.values()
            graph, first = loop.graph, out
    assert counts == [(2, 2 * 81), (2, 2 * 80)]
    assert graph is not None and loop.graph is graph and len(eng._decode_loops) == 1
    assert torch.equal(out, first) and torch.equal(out, _eager_loop(eng, ids, 80))


def test_generate_refuses_a_side_stream(gen):
    """The decode kernel's merge semaphores are shared per device, so
    generate runs on the default stream only."""
    eng = _graph_engine(gen)
    ids = torch.randint(0, 512, (2, 8), generator=gen, device="cuda")
    with torch.cuda.stream(torch.cuda.Stream()):
        with pytest.raises(RuntimeError, match="default stream"):
            eng.generate(ids, max_new_tokens=2)


def test_sampled_graphed_decode_draws_the_eager_stream(gen):
    """Sampling inside the graph: the generator registered with the graph
    and reseeded per call gives, per seed, the eager loop's draws."""
    eng = _graph_engine(gen)
    ids = torch.randint(0, 512, (4, 16), generator=gen, device="cuda")
    kw = dict(do_sample=True, temperature=1.0, top_k=50)
    a = eng.generate(ids, max_new_tokens=12, seed=5, **kw)
    b = eng.generate(ids, max_new_tokens=12, seed=5, **kw)
    c = eng.generate(ids, max_new_tokens=12, seed=6, **kw)
    assert torch.equal(a, b) and torch.equal(a, _eager_loop(eng, ids, 12, seed=5, **kw))
    assert torch.equal(c, _eager_loop(eng, ids, 12, seed=6, **kw)) and not torch.equal(a, c)


GRAD_TOL = {torch.bfloat16: 1e-2, torch.float16: 2.5e-3}


def _flash_kernels(gen, BH, t_q, t_k, D, dtype, causal):
    """The tensor-core forward, dq and dk/dv kernels against their plain
    versions in fp32 on the same inputs. → (dk, dv)."""
    q, do = (torch.randn(BH, t_q, D, generator=gen, device="cuda") for _ in range(2))
    k, v = (torch.randn(BH, t_k, D, generator=gen, device="cuda") for _ in range(2))
    q, k, v, do = (q * D ** -0.5).to(dtype), k.to(dtype), v.to(dtype), do.to(dtype)
    o, lse = tfa.flash_forward(q, k, v, causal)
    o_ref, lse_ref = tfa.mha_reference_lse(q.float(), k.float(), v.float(), causal)
    assert torch.isfinite(o).all()
    assert (o.float() - o_ref).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    delta = (do.float() * o.float()).sum(-1)
    dq = tfa.flash_backward_dq(q, k, v, do, lse, delta, causal)
    dk, dv = tfa.flash_backward_dkv(q, k, v, do, lse, delta, causal)
    refs = tfa.mha_backward_reference(q.float(), k.float(), v.float(), do.float(), lse, delta,
                                      causal)
    for name, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        err = (g.float() - r).abs().max().item()
        assert torch.isfinite(g).all() and err <= GRAD_TOL[dtype] * max(1.0, r.abs().max().item()), \
            (name, err)
    return dk, dv


@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 200, 1000])
def test_tensor_core_kernels_at_tile_edges(gen, T):
    """Ragged and whole 64-row tiles, causal, bf16, head dim 96."""
    _flash_kernels(gen, 16, T, T, 96, torch.bfloat16, True)


@pytest.mark.parametrize("D", [64, 96, 128, 16, 32, 80])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tensor_core_kernels_per_head_dim_and_type(gen, D, dtype):
    _flash_kernels(gen, 8, 200, 200, D, dtype, True)


def test_tensor_core_kernels_noncausal_with_more_keys_than_queries(gen):
    _flash_kernels(gen, 8, 100, 300, 96, torch.bfloat16, False)


def test_causal_keys_no_query_sees_get_exact_zeros(gen):
    """Top-left causal with Tq=64 < Tk=200: keys 64.. are seen by no query,
    and their dk and dv are exactly 0."""
    dk, dv = _flash_kernels(gen, 8, 64, 200, 96, torch.bfloat16, True)
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
    assert torch.equal(tfa.flash_backward_dq(q, k, v, do, lse, delta, True),
                       tfa.flash_backward_dq(q, k, v, do, lse, delta, True))
    dk, dv = tfa.flash_backward_dkv(q, k, v, do, lse, delta, True)
    dk2, dv2 = tfa.flash_backward_dkv(q, k, v, do, lse, delta, True)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("t_q,t_k,causal", [
    (1, 1, True), (63, 63, True), (64, 64, True), (65, 65, True), (127, 127, True),
    (200, 200, True), (1000, 1000, True), (100, 300, False), (64, 200, True),
    (300, 100, True), (300, 100, False)])
def test_flash_dq_tensor_core_matches_plain(gen, t_q, t_k, causal, dtype):
    """The tensor-core dq at the 64-row tiles' edges, with Tq != Tk both ways
    and top-left causal masking."""
    q, do = (torch.randn(8, t_q, 96, generator=gen, device="cuda") for _ in range(2))
    k, v = (torch.randn(8, t_k, 96, generator=gen, device="cuda") for _ in range(2))
    q, k, v, do = (q * 96 ** -0.5).to(dtype), k.to(dtype), v.to(dtype), do.to(dtype)
    o, lse = tfa.flash_forward(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    before = tfa.BWD_KERNEL.entry_launches["flash_attention_bwd_dq"]
    dq = tfa.flash_backward_dq(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert tfa.BWD_KERNEL.entry_launches["flash_attention_bwd_dq"] == before + 1
    ref = tfa.mha_backward_dq_reference(q.float(), k.float(), v.float(), do.float(), lse, delta,
                                        causal)
    err = (dq.float() - ref).abs().max().item()
    assert torch.isfinite(dq).all() and err <= GRAD_TOL[dtype] * max(1.0, ref.abs().max().item())


def test_kernel_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    q = torch.randn(2, 16, 48, generator=gen, device="cuda")      # head dim 48
    with pytest.raises(ValueError):
        tfa.flash_forward(q, q, q)
    with pytest.raises(ValueError):
        tda.decode_attention(q, q[:, :, None], q[:, :, None], 3)


def test_generate_kernel_path_matches_plain_path(gen):
    """fp32, head dim 64: greedy tokens of the kernel path equal the plain
    path's, and every layer launched each kernel (decode once per step)."""
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
    # a first call with its key: 12 steps and the warm-up step before the capture
    assert (tfa.KERNEL.launches - fa0, tda.KERNEL.launches - da0) == (2, 2 * (12 + 1))
    assert torch.equal(out, eng_p.generate(ids, max_new_tokens=12))


@pytest.mark.parametrize("BH,T,D,causal,dtype,tol", [
    (32, 200, 96, True, torch.bfloat16, 1e-2), (16, 128, 64, False, torch.float32, 1e-4),
    (8, 77, 128, True, torch.float32, 1e-4), (16, 130, 64, True, torch.float16, 2.5e-3),
    (16, 130, 80, True, torch.float32, 1e-4), (16, 100, 16, False, torch.float32, 1e-4),
    (8, 77, 32, True, torch.float32, 1e-4), (16, 130, 80, True, torch.bfloat16, 1e-2)])
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


def test_generate_fp16_runs_the_decode_kernel(gen):
    """fp16 serving through the decode kernel: every layer launches each
    kernel, and the logits of one decode step agree with the plain path's
    (bf16-level tolerance, 2e-2 of the largest)."""
    cfg = dataclasses.replace(PRESETS["llama-tiny"], n_embd=256, n_head=4, n_kv_head=2,
                              intermediate_size=512, dtype=torch.float16,
                              use_flash_decode=True)
    model = LlamaModel(cfg).init_params(gen)
    plain = LlamaModel(dataclasses.replace(cfg, use_flash_attention=False,
                                           use_flash_decode=False))
    plain.load_state_dict(model.state_dict(), assign=True)
    eng = deepspeed_tpu_torch.init_inference(model, {"dtype": "fp16"})
    ids = torch.randint(0, cfg.vocab_size, (3, 20), generator=gen, device="cuda")
    fa0, da0 = tfa.KERNEL.launches, tda.KERNEL.launches
    out = eng.generate(ids, max_new_tokens=12)
    # a first call with its key: 12 steps and the warm-up step before the capture
    assert (tfa.KERNEL.launches - fa0, tda.KERNEL.launches - da0) == (2, 2 * (12 + 1))
    assert out.shape == (3, 32)
    with torch.inference_mode():
        logits, cache = model.prefill(ids, model.init_cache(3, 32))
        ref, ref_cache = plain.prefill(ids, plain.init_cache(3, 32))
        tok = torch.argmax(ref, dim=-1)
        step, _ = model.decode_step(tok, cache)
        step_ref, _ = plain.decode_step(tok, ref_cache)
    assert torch.isfinite(step).all()
    assert (step.float() - step_ref.float()).abs().max().item() <= \
        2e-2 * step_ref.float().abs().max().item()


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("sparse", [False, True])
def test_gpt2_head_dim_80_runs_the_kernels(gen, sparse, dtype, rtol):
    """GPT-2 at head dim 80 (n_embd 160, 2 heads), the head dim of the
    gpt2-2.7b preset: dense and with a sparse_attention block, the forward
    and backward launch the kernels once per layer and agree with the model
    on its plain path. fp32 differs only in summation order (1e-4); in bf16
    the loss and gradients carry the inputs' rounding (the bf16 gradient
    tolerance, 5e-2, relative L2)."""
    block = {"mode": "fixed", "block": 16, "num_local_blocks": 4} if sparse else None
    cfg = gpt2.GPT2Config(vocab_size=1024, n_positions=128, n_embd=160, n_layer=2, n_head=2,
                          remat=False, dtype=dtype, sparse_attention=block)
    model = gpt2.GPT2Model(cfg).init_params(gen)
    batch = gpt2.synthetic_lm_batch(2, 128, cfg.vocab_size, device="cuda")
    for kern in (tfa.KERNEL, tfa.BWD_KERNEL, tfa.SPARSE_KERNEL):
        kern.reset_launches()
    loss = model.loss(batch)
    loss.backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.float() for n, p in model.named_parameters()}
    if sparse:
        assert tfa.SPARSE_KERNEL.entry_launches == dict.fromkeys(
            tfa.SPARSE_KERNEL.entry_launches, 2)
        assert tfa.KERNEL.launches == tfa.BWD_KERNEL.launches == 0
    else:
        assert (tfa.KERNEL.launches, tfa.BWD_KERNEL.entry_launches["flash_attention_bwd_dq"],
                tfa.BWD_KERNEL.entry_launches["flash_attention_bwd_dkv"]) == (2, 2, 2)
        assert tfa.SPARSE_KERNEL.launches == 0
    model.zero_grad(set_to_none=True)
    if sparse:
        layout = model._sparse.get_layout(128)
        model._sparse_attention = lambda q, k, v: tfa.sparse_mha_reference(q, k, v, layout)
    else:
        model.config = dataclasses.replace(cfg, use_flash_attention=False)
    loss_p = model.loss(batch)
    loss_p.backward()
    assert torch.isfinite(loss) and abs(loss.item() - loss_p.item()) <= rtol * abs(loss_p.item())
    for n, p in model.named_parameters():
        diff = (grads[n] - p.grad.float()).norm().item()
        assert diff <= rtol * max(p.grad.float().norm().item(), 1e-30), n


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
    assert engine.module.wte.dtype == dtype
    assert all(t.dtype == torch.float32 for t in engine._zero.fp32)
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
@pytest.mark.parametrize("D", [64, 96, 128, 16, 32, 80])
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


def _sparse_forward_checked(gen, lay, T, D, dtype, causal, BH=4):
    """The sparse forward kernel against its plain version in fp32 on the
    same inputs, twice (the bits must repeat); one launch each."""
    q, k, v = (torch.randn(BH, T, D, generator=gen, device="cuda") for _ in range(3))
    q, k, v = (q * D ** -0.5).to(dtype), k.to(dtype), v.to(dtype)
    before = tfa.SPARSE_KERNEL.entry_launches["sparse_attention_fwd"]
    o, lse = tfa.sparse_forward(q, k, v, lay, causal)
    o2, lse2 = tfa.sparse_forward(q, k, v, lay, causal)
    torch.cuda.synchronize()
    assert tfa.SPARSE_KERNEL.entry_launches["sparse_attention_fwd"] == before + 2
    o_ref, lse_ref = tfa.sparse_reference_lse(q.float(), k.float(), v.float(), lay, causal)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert torch.isfinite(o).all() and (o.float() - o_ref).abs().max().item() <= tol
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 96, 128, 16, 32, 80])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_sparse_tensor_core_forward_matches_plain(gen, block, D, dtype, causal):
    """The tensor-core sparse forward over the query side's CTA schedule:
    eight layout blocks of the fixed layout (causal) or BigBird (not
    causal)."""
    T = 8 * block
    cfg = FixedSparsityConfig(4, block=block, num_local_blocks=4) if causal \
        else BigBirdSparsityConfig(4, block=block)
    _sparse_forward_checked(gen, cfg.make_layout(T), T, D, dtype, causal)


@pytest.mark.parametrize("block,D,causal", [(16, 128, True), (128, 96, True), (32, 64, False),
                                           (16, 80, True), (32, 16, False), (64, 32, True)])
def test_sparse_fp32_forward_on_the_cuda_cores(gen, block, D, causal):
    T = 8 * block
    cfg = FixedSparsityConfig(4, block=block, num_local_blocks=4) if causal \
        else BigBirdSparsityConfig(4, block=block)
    _sparse_forward_checked(gen, cfg.make_layout(T), T, D, torch.float32, causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sparse_backward_warps_of_one_cta_with_disjoint_lists(gen, dtype, causal):
    """Each query block attends only itself: the four warps of a CTA walk
    four different chunks, none shared."""
    n = 16
    lay = np.eye(n, dtype=bool)
    pairs = tfa.sparse_pairs(lay, causal, 16 * n, "cuda")
    assert all(bin(int(m)).count("1") == 1 for m in pairs.dq.masks)
    _sparse_forward_checked(gen, lay, 16 * n, 64, dtype, causal)
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


@pytest.mark.parametrize("block,D,causal", [(16, 128, True), (128, 96, True), (32, 64, False),
                                           (16, 80, True), (32, 16, False), (64, 32, True)])
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


# ------------------------------------------- feed, save and resume on the card
RESUME_CONFIG = {"train_batch_size": 4, "bf16": {"enabled": True}, "gradient_clipping": 1.0,
                 "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
                 "steps_per_print": 0}


def _resume_model():
    return gpt2.GPT2Model(gpt2.GPT2Config(vocab_size=1024, n_positions=128, n_embd=256,
                                          n_layer=2, n_head=4, remat=False))


def _token_rows(n=24, T=128):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 1024, size=T, dtype=np.int32) for _ in range(n)]


def _bits(t):
    return t.reshape(-1).view(torch.uint8) if t.is_floating_point() else t


def test_checkpoint_resume_on_the_card_is_bitwise(gen, tmp_path):
    """bf16 with fp32 masters: two engines built from other seeds load a tag
    saved mid-run; each holds the saved state bit for bit and continues
    with the uninterrupted run's losses through its own restored loader."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import flatten_state

    data = _token_rows()
    a, _, loader, _ = deepspeed_tpu_torch.initialize(model=_resume_model(),
                                                     config=dict(RESUME_CONFIG),
                                                     training_data=data)
    it = iter(loader)
    for _ in range(2):
        a.train_batch(data_iter=it)
    saved = {k: v.clone() for k, v in flatten_state(a).items()}
    a.save_checkpoint(str(tmp_path))
    control = [float(a.train_batch(data_iter=it)) for _ in range(2)]
    for seed in (1, 2):
        e, _, ld, _ = deepspeed_tpu_torch.initialize(model=_resume_model(),
                                                     config={**RESUME_CONFIG, "seed": seed},
                                                     training_data=data)
        path, _ = e.load_checkpoint(str(tmp_path))
        assert path.endswith("global_step2") and e.device.type == "cuda"
        restored = flatten_state(e)
        assert restored.keys() == saved.keys()
        for k, v in saved.items():
            # the tensors live on the card, the step counters are host numbers
            assert restored[k].device == v.device and torch.equal(_bits(restored[k]), _bits(v)), k
        ite = iter(ld)
        assert [float(e.train_batch(data_iter=ite)) for _ in range(2)] == control


def test_async_save_on_the_card_writes_latest_last(gen, tmp_path):
    """The save blocks for the copy to the host only; the files it commits
    hold the state at the call, though the next step ran meanwhile; the
    commit marker, client_state.json, the manifest and latest land in
    that order."""
    from deepspeed_tpu_torch.resilience.manifest import verify_tag
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (read_state,
                                                                       wait_for_pending_saves)

    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=_resume_model(), config=dict(RESUME_CONFIG), training_data=_token_rows())
    it = iter(loader)
    engine.train_batch(data_iter=it)
    want = {n: p.detach().clone() for n, p in engine.module.named_parameters()}
    engine.save_checkpoint(str(tmp_path))
    engine.train_batch(data_iter=it)
    wait_for_pending_saves()
    rec = engine._last_save
    assert "error" not in rec and rec["blocking_s"] < rec["commit_s"]
    tag = tmp_path / "global_step1"
    assert (tmp_path / "latest").read_text() == "global_step1" and verify_tag(str(tag))[0]
    got = read_state(str(tag), ("params",), "cuda")
    for n, p in want.items():
        assert torch.equal(_bits(got[f"params/{n}"]), _bits(p)), n
    times = [os.stat(p).st_mtime_ns for p in (tag / "state" / "_CHECKPOINT_METADATA",
                                               tag / "client_state.json", tag / "manifest.json",
                                               tmp_path / "latest")]
    assert times == sorted(times)


def test_seqlen_curriculum_runs_the_kernels_at_every_length(gen):
    """The legacy curriculum_learning block cuts T on the host: 40, 72, 96,
    then 128 tokens, ragged against the kernels' 64-row tiles; each step
    launches every dense kernel once per layer."""
    config = {**RESUME_CONFIG, "curriculum_learning": {
        "enabled": True, "curriculum_type": "seqlen", "min_difficulty": 16,
        "max_difficulty": 128, "schedule_type": "fixed_linear",
        "schedule_config": {"total_curriculum_step": 4, "difficulty_step": 8}}}
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(model=_resume_model(), config=config,
                                                          training_data=_token_rows())
    it = iter(loader)
    lengths = []
    for _ in range(5):
        tfa.KERNEL.reset_launches()
        tfa.BWD_KERNEL.reset_launches()
        assert torch.isfinite(engine.train_batch(data_iter=it))
        lengths.append(engine.curriculum_scheduler.get_current_difficulty())
        assert (tfa.KERNEL.launches, tfa.BWD_KERNEL.entry_launches["flash_attention_bwd_dq"],
                tfa.BWD_KERNEL.entry_launches["flash_attention_bwd_dkv"]) == (2, 2, 2)
    assert lengths == [40, 72, 96, 128, 128]


# ------------------------------------------------------------------ ZeRO
ZERO_CONFIG = {"train_batch_size": 4, "gradient_clipping": 1.0, "steps_per_print": 0,
               "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}}}


@pytest.fixture
def nccl_world(gen):
    """A NCCL process group of one, destroyed after the test."""
    import socket

    from deepspeed_tpu_torch import comm

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    comm.init_distributed(init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1,
                          timeout=120)
    yield comm
    comm.destroy_process_group()


def _zero_engine(stage, dtype, extra=None):
    cfg = gpt2.GPT2Config(vocab_size=1024, n_positions=128, n_embd=256, n_layer=2, n_head=4,
                          remat=False, dtype=dtype)
    config = {**ZERO_CONFIG, "zero_optimization": {
        "stage": stage, "stage3_param_persistence_threshold": 1000}, **(extra or {})}
    if dtype == torch.bfloat16:
        config["bf16"] = {"enabled": True}
    engine, *_ = deepspeed_tpu_torch.initialize(model=gpt2.GPT2Model(cfg), config=config)
    return engine


@pytest.mark.parametrize("dtype,rtol", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
def test_zero_stages_train_alike_over_nccl(nccl_world, dtype, rtol):
    """Stages 0-3 from the same seed and batch: the losses of stage 0,
    two launches of each dense kernel per step, and under stage 3 the
    gathers (a forward's 4 and a backward's 2 for 2 layers)."""
    assert nccl_world.get_backend() == "nccl"
    batch = gpt2.synthetic_lm_batch(4, 128, 1024, device="cuda")
    losses = {}
    for stage in range(4):
        engine = _zero_engine(stage, dtype)
        tfa.KERNEL.reset_launches()
        tfa.BWD_KERNEL.reset_launches()
        losses[stage] = [float(engine.train_batch(batch)) for _ in range(3)]
        assert (tfa.KERNEL.launches, tfa.BWD_KERNEL.entry_launches["flash_attention_bwd_dq"],
                tfa.BWD_KERNEL.entry_launches["flash_attention_bwd_dkv"]) == (6, 6, 6)
        assert engine._zero.gathers == (18 if stage == 3 else 0)
        assert engine.module_state_dict()["wte"].shape == (1024, 256)
    for stage in (1, 2, 3):
        np.testing.assert_allclose(losses[stage], losses[0], rtol=rtol, err_msg=str(stage))


def test_zero_stage3_tag_restores_at_stage1_over_nccl(nccl_world, tmp_path):
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import flatten_state

    batch = gpt2.synthetic_lm_batch(4, 128, 1024, device="cuda")
    a = _zero_engine(3, torch.bfloat16, {"checkpoint": {"async_save": False}})
    a.train_batch(batch)
    saved = {k: v.clone() for k, v in flatten_state(a).items()}
    a.save_checkpoint(str(tmp_path))
    b = _zero_engine(1, torch.bfloat16, {"seed": 5})
    path, _ = b.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step1")
    restored = flatten_state(b)
    assert restored.keys() == saved.keys()
    for k, v in saved.items():
        assert torch.equal(_bits(restored[k]), _bits(v)), k


def test_zero_stage3_state_gathers_one_unit_at_a_time_over_nccl(nccl_world):
    """The whole state of a stage-3 engine comes to the host one unit at a
    time: the card's peak during ``flatten_state`` is the state plus the
    largest unit's fp32 buffer at most."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import flatten_state

    engine = _zero_engine(3, torch.bfloat16)
    engine.train_batch(gpt2.synthetic_lm_batch(4, 128, 1024, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    state = flatten_state(engine)
    above = torch.cuda.max_memory_allocated() - before
    assert all(t.device.type == "cpu" for t in state.values())
    assert 0 < above <= 4 * max(u.length for u in engine._plan.units) + 2 ** 20, above


def test_comm_collectives_over_nccl(nccl_world):
    """Every collective of ``comm`` on card tensors over NCCL: at a world of
    one each returns its input (or the group's one slot of it)."""
    comm = nccl_world
    x = torch.arange(8, dtype=torch.float32, device="cuda")
    for op in ("sum", "avg", "max", "min", "product"):
        assert torch.equal(comm.all_reduce(x.clone(), op=op), x), op
    assert torch.equal(comm.all_gather_into_tensor(torch.empty_like(x), x), x)
    assert torch.equal(comm.reduce_scatter_tensor(torch.empty_like(x), x, op="avg"), x)
    assert torch.equal(comm.all_to_all_single(torch.empty_like(x), x), x)
    assert torch.equal(comm.broadcast(x.clone(), src=0), x)
    assert torch.equal(comm.reduce(x.clone(), dst=0), x)
    assert torch.equal(comm.all_gather([torch.empty_like(x)], x)[0], x)
    assert torch.equal(comm.gather(x, [torch.empty_like(x)], dst=0)[0], x)
    assert torch.equal(comm.scatter(torch.empty_like(x), [x], src=0), x)
    a, b = comm.all_gather_coalesced([x, x[:3]])
    assert torch.equal(a, x) and torch.equal(b, x[:3])
    assert all(torch.equal(t, x) for t in comm.all_reduce_coalesced([x.clone(), x.clone()]))
    assert torch.equal(comm.ppermute(x, [(0, 0)]), x)
    assert comm.broadcast_object_list(["tag"]) == ["tag"]
    comm.barrier()
    comm.monitored_barrier(timeout=60)
    assert (comm.get_rank(), comm.get_world_size(), comm.get_backend()) == (0, 1, "nccl")
    assert deepspeed_tpu_torch.get_accelerator().communication_backend_name() == "nccl"


# ---------------------------------------------------------------- offload
OFFLOAD_CONFIG = {"train_batch_size": 4, "steps_per_print": 0, "gradient_clipping": 1.0,
                  "bf16": {"enabled": True},
                  "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}}}


def _offload_run(monkeypatch, zero, knobs):
    for k in ("DS_TPU_OFFLOAD_MASTER", "DS_TPU_FORCE_STREAMED_OFFLOAD",
              "DS_TPU_OFFLOAD_CHUNK_BYTES"):
        monkeypatch.delenv(k, raising=False)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    cfg = gpt2.GPT2Config(vocab_size=1024, n_positions=128, n_embd=256, n_layer=2, n_head=4,
                          remat=False)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2.GPT2Model(cfg), config={**OFFLOAD_CONFIG, "zero_optimization": zero})
    batch = gpt2.synthetic_lm_batch(4, 128, 1024, device="cuda")
    losses = [float(engine.train_batch(batch)) for _ in range(3)]
    return engine, losses, {k: v.clone() for k, v in engine.module_state_dict().items()}


@pytest.mark.parametrize("zero,knobs", [
    ({"stage": 1, "offload_optimizer": {"device": "cpu"}}, {}),
    ({"stage": 1, "offload_optimizer": {"device": "cpu"}},
     {"DS_TPU_FORCE_STREAMED_OFFLOAD": "1", "DS_TPU_OFFLOAD_MASTER": "host",
      "DS_TPU_OFFLOAD_CHUNK_BYTES": str(1 << 20)}),
    ({"stage": 1, "offload_optimizer": {"device": "cpu", "stream_overlap": True}},
     {"DS_TPU_FORCE_STREAMED_OFFLOAD": "1", "DS_TPU_OFFLOAD_MASTER": "host",
      "DS_TPU_OFFLOAD_CHUNK_BYTES": str(1 << 20)}),
    ({"stage": 3, "stage3_param_persistence_threshold": 1000,
      "offload_param": {"device": "cpu"}, "offload_optimizer": {"device": "cpu"}},
     {"DS_TPU_FORCE_STREAMED_OFFLOAD": "1", "DS_TPU_OFFLOAD_MASTER": "host",
      "DS_TPU_OFFLOAD_CHUNK_BYTES": str(1 << 20)}),
])
def test_offloaded_update_equals_the_in_card_update(gen, monkeypatch, zero, knobs):
    _, ref_losses, ref = _offload_run(monkeypatch, {"stage": zero["stage"],
                                                    "stage3_param_persistence_threshold": 1000},
                                      {})
    engine, losses, params = _offload_run(monkeypatch, zero, knobs)
    z = engine._zero
    host = list(engine.opt_state.mu) + list(engine.opt_state.nu) + \
        (list(z.fp32) if engine._offload.master_host else []) + \
        [z.parts[u] for u in z.parts if "offload_param" in zero]
    assert host and all(t.device.type == "cpu" and t.is_pinned() for t in host)
    assert losses == ref_losses
    for k, v in ref.items():
        assert torch.equal(params[k], v), k


def test_aio_reads_into_a_pinned_tensor(gen, tmp_path):
    from deepspeed_tpu_torch.ops.aio import AsyncIOHandle, host_zeros

    src = host_zeros(1 << 22).random_(0, 255)
    dst = host_zeros(1 << 22, pin=True)
    assert dst.is_pinned() and dst.data_ptr() % 4096 == 0
    h = AsyncIOHandle(block_size=1 << 20, thread_count=4)
    h.sync_pwrite(src, str(tmp_path / "swap.bin"))
    h.async_pread(dst, str(tmp_path / "swap.bin"))
    h.wait()
    assert torch.equal(dst.to("cuda", non_blocking=True).cpu(), src)
