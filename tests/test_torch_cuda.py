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
head dims of the model presets; the dense forward also has 40, 160, 256
and 512 (SD-1.5's UNet and VAE, GPT-J-6B), forward only: a gradient at
those raises at the forward; decode also has 256. A small UNet and VAE run through the kernels on the card against
the same models with the plain attention. The last tests feed a small bf16 GPT-2
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
straight into a pinned tensor. The last tests run the flash kernels at
llama3.2-1b's training shape (causal) and bert-large's (non-causal, bf16
and fp16), a BERT step through the non-causal kernels (and, with an
attention_mask, through none), a BERT fp16 LAMB run through the engine,
and a grouped-KV llama step under remat. The MoE tests run the flash
kernels at gpt2-moe-125m's training shape, a MoE GPT-2 step under remat
per pair through the kernels against the plain path, and its graphed
decode loop (the gate captured with the step) against the eager loop. The
GPT-2 variant families (GPT-J at head dim 256, GPT-NeoX, OPT, GPT-Neo with
its local layers on the plain path, BLOOM's ALiBi with no kernel) serve
through the graphed loop with their launches counted; the remat policies
launch K1 once ("attn", "attn_mlp") or twice ("full", "dots") per layer
and step; dropout under remat "attn" equals remat off on one seed. K1 and
K3 also take head dim 256 (GPT-J-6B), K1 forward only. Model import:
llama3.2-1b's widths at 2 layers exported to HF's layout and imported back
serve through the kernels like the port's own model, and a Megatron
directory at gpt2-760m's widths (tp 2) serves the greedy tokens of its
state dict. The switches of one card: a llama served with int8 and int4
weights dequantized inside the captured decode step gives the eager
loop's tokens and those of its dequantized weights served in bf16;
``cpu_checkpointing`` keeps pinned host copies and the plain gradients; a
block-sparse MoE step launches the sparse kernels; random-LTD's gather
and scatter on the card equal the CPU's. The RLHF actor: the hybrid
engine's one captured decode graph, replayed after each step, gives the
eager loop's tokens on the updated params (stages 0, 2, 3 and under MoQ);
fake quantization and the pruning masks on the card equal the CPU's bit
for bit; the eigenvalue estimate launches no K1 or K2. Monitoring and
profiling: the flops profiler counts a step through K1/K2 on the card as
it counts the plain step on the CPU, and the memory census's total is the
allocator's. Compression under ZeRO stage 3: the compressed values the
stage-3 units' gathers hand out (from the card, or from pinned host memory
under ``offload_param``) equal the stage-1 refresh's bit for bit; with the
goodput meter's flag armed, a decode-graph capture is a compile span.
"""

import dataclasses
import os
import types

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


@pytest.mark.parametrize("dh", [16, 32, 80, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)])
def test_decode_kernel_per_head_dim(gen, dh, dtype, tol):
    """The head dims of the tiny and 2.7b presets and GPT-J-6B's 256; at 16
    and 80 the upper lanes own no column of the last group of 32."""
    _decode_checked(gen, 8, 200, dtype, tol, dh)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_decode_kernel_mha_head_dim_96(gen, dtype):
    """gpt2's serving layout: one query head per KV head (most rows of the
    tensor-core tile are padding) at head dim 96, cache full to its end."""
    _decode_checked(gen, 32, 255, dtype, 2e-2, 96)


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


def test_a_dead_graph_is_not_freed_inside_a_capture(gen, monkeypatch):
    """A captured graph left in a reference cycle (a loop the serving
    front-end abandoned) and collected while another capture runs would
    invalidate that capture. Here the collector is off until the decode
    step is being captured and then runs at almost every allocation: the
    decode loop collects before it captures, so the dead graph is gone by
    then, the capture succeeds and replays the eager loop's tokens."""
    import gc

    from deepspeed_tpu_torch.inference.engine import DecodeLoop

    eng = _graph_engine(gen)
    ids = torch.randint(0, 512, (2, 16), generator=gen, device="cuda")
    step = DecodeLoop.step

    def collecting_while_captured(self):
        if torch.cuda.is_current_stream_capturing():
            gc.set_threshold(1)
            gc.enable()
        return step(self)

    monkeypatch.setattr(DecodeLoop, "step", collecting_while_captured)
    enabled, threshold = gc.isenabled(), gc.get_threshold()
    gc.disable()
    try:
        x = torch.zeros(8, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            x.add_(1)
        torch.cuda.current_stream().wait_stream(side)
        dead = torch.cuda.CUDAGraph()
        with torch.cuda.graph(dead):
            x.add_(1)
        cycle = {"graph": dead}
        cycle["self"] = cycle
        del dead, cycle
        out = eng.generate(ids, max_new_tokens=8)
    finally:
        gc.set_threshold(*threshold)
        (gc.enable if enabled else gc.disable)()
    monkeypatch.undo()
    assert torch.equal(out, _eager_loop(eng, ids, 8))


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


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [40, 160, 256, 512])
def test_forward_only_head_dims_match_plain(gen, D, causal, dtype, tol):
    """The forward at the UNet's, GPT-J's and the VAE's head dims (40 padded
    to the mma k-step, 160, 256 and 512 on the sliced plan, 256 in one
    slice), at tile edges and with Tq != Tk (77 keys: the
    cross-attention's)."""
    for t_q, t_k in ((1, 1), (65, 7), (130, 77), (200, 333), (64, 200)):
        q = torch.randn(6, t_q, D, generator=gen, device="cuda") * D ** -0.5
        k, v = (torch.randn(6, t_k, D, generator=gen, device="cuda") for _ in range(2))
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        before = tfa.KERNEL.launches
        o, lse = tfa.flash_forward(q, k, v, causal)
        o2, _ = tfa.flash_forward(q, k, v, causal)
        o_ref, lse_ref = tfa.mha_reference_lse(q.float(), k.float(), v.float(), causal)
        assert tfa.KERNEL.launches == before + 2
        assert torch.isfinite(o).all() and torch.equal(o, o2)
        assert (o.float() - o_ref).abs().max().item() <= tol, (t_q, t_k)
        assert (lse - lse_ref).abs().max().item() <= 1e-3, (t_q, t_k)


@pytest.mark.parametrize("D", [40, 160, 256, 512])
def test_forward_raises_when_a_gradient_needs_a_missing_backward(gen, D):
    """No backward kernel at these head dims: the forward refuses a call
    that needs gradients, before it launches anything; without gradients it
    runs."""
    q, k, v = (torch.randn(1, 16, 2, D, generator=gen, device="cuda") for _ in range(3))
    before = tfa.KERNEL.launches
    with pytest.raises(NotImplementedError, match=f"head dim {D}"):
        tfa.flash_attention(q.requires_grad_(), k, v, causal=False)
    assert tfa.KERNEL.launches == before
    with torch.no_grad():
        out = tfa.flash_attention(q, k, v, causal=False)
    assert tfa.KERNEL.launches == before + 1 and torch.isfinite(out).all()


def _plain_attention(q, k, v, use_flash=True, causal=True):
    return tfa.mha_reference(q, k, v, causal=causal)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
def test_small_unet_and_vae_on_the_card_match_the_plain_path(gen, monkeypatch, dtype, rtol):
    """A 2-block UNet (8 heads: head dim 40 at 320 channels, 80 in the mid
    block, 77 context keys) and a 2-block VAE (its single-head mid attention
    on 512 channels) through init_inference on the card, their K1 launches
    counted, held to the same models with the plain attention."""
    from deepspeed_tpu_torch.models import diffusion as td

    # fp32 convolutions in fp32: TF32 rounds their inputs to 10 bits, which
    # the two paths' last-bit differences can land on either side of
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    ucfg = td.UNetConfig(block_out_channels=(320, 640), layers_per_block=1,
                         down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                         up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), dtype=dtype)
    vcfg = td.VAEConfig(block_out_channels=(128, 512), layers_per_block=1, dtype=dtype)
    dt = {torch.float32: "fp32", torch.bfloat16: "bf16"}[dtype]
    unet = deepspeed_tpu_torch.init_inference(td.UNet2DConditionModel(ucfg),
                                              config={"dtype": dt})
    vae = deepspeed_tpu_torch.init_inference(td.AutoencoderKL(vcfg), config={"dtype": dt})
    x = torch.randn(2, 4, 32, 32, generator=gen, device="cuda")
    ctx = torch.randn(2, 77, 768, generator=gen, device="cuda")
    img = torch.randn(1, 3, 64, 64, generator=gen, device="cuda")
    t = torch.tensor([10, 700], device="cuda")
    before = tfa.KERNEL.launches
    out_u, out_v = unet(x, t, ctx), vae(img)
    # UNet: self and cross in four transformers (down block 0, mid, two in up
    # block 1); VAE: the encoder's and the decoder's mid attention
    assert tfa.KERNEL.launches == before + 8 + 2
    monkeypatch.setattr(td, "local_causal_attention", _plain_attention)
    ref_u, ref_v = unet(x, t, ctx), vae(img)
    assert tfa.KERNEL.launches == before + 10
    for out, ref in ((out_u, ref_u), (out_v, ref_v)):
        assert out.dtype == dtype and torch.isfinite(out.float()).all()
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= rtol * ref.float().abs().max().item(), err


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


def test_comm_spans_wait_for_the_card_only_under_the_logger(nccl_world, tmp_path, monkeypatch):
    """A telemetry session alone records each card collective's span
    without a synchronize; a CommsLogger waits for it, as before."""
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.runtime.config import TelemetryConfig

    comm = nccl_world
    waits = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: (waits.append(a), real(*a)))
    x = torch.arange(8, dtype=torch.float32, device="cuda")
    telemetry.configure(TelemetryConfig(enabled=True, output_dir=str(tmp_path)))
    try:
        comm.all_reduce(x.clone())
        assert not waits
        comm.configure(enabled=True)
        try:
            comm.all_reduce(x.clone())
        finally:
            comm.configure(enabled=False)
        assert len(waits) == 1
        spans = [e for e in telemetry.get_tracer().events if e.get("cat") == "comm"]
        assert [(e["args"]["op"], e["args"]["seq"]) for e in spans] == [
            ("all_reduce", 0), ("all_reduce", 1)]
    finally:
        telemetry.deconfigure()


def test_functional_reduce_scatter_and_barrier_default_over_nccl(nccl_world):
    comm = nccl_world
    x = torch.arange(24, dtype=torch.float32, device="cuda").view(4, 6)
    assert torch.equal(comm.reduce_scatter(x), x)
    assert torch.equal(comm.reduce_scatter(x, scatter_dimension=1, op="avg"), x)
    comm.set_default_barrier_timeout(60)
    try:
        comm.monitored_barrier()
    finally:
        comm.set_default_barrier_timeout(None)


def test_accelerator_answers_from_the_card(gen):
    accel = deepspeed_tpu_torch.get_accelerator()
    accel.set_device(0)
    assert accel.current_device() == 0 and accel.device_count() >= 1
    assert accel.global_device_count() == accel.device_count()
    total, free = accel.total_memory(), accel.available_memory()
    assert 0 < free <= total == torch.cuda.get_device_properties(0).total_memory
    assert "allocated_bytes.all.current" in accel.memory_stats()
    assert accel.is_bf16_supported() and accel.is_fp16_supported()
    assert accel.on_accelerator(torch.ones(1, device="cuda"))
    assert accel.create_op_builder("decode_attention") is tda.KERNEL
    assert tda.KERNEL.library_path.exists()


def test_serve_a_training_tag_on_the_card(gen, tmp_path):
    """A 2-layer bf16 gpt2 trained a step and saved, served through
    ``init_inference(checkpoint=...)``: the tag's params bit for bit; the
    graphed generate launches the flash kernel once per layer and the
    decode kernel once per layer and step (the warm-up's step too) and
    gives the eager loop's tokens."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import read_state

    cfg = gpt2.GPT2Config(vocab_size=1024, n_positions=256, n_embd=256, n_layer=2, n_head=4,
                          remat=False)
    engine, *_ = deepspeed_tpu_torch.initialize(model=gpt2.GPT2Model(cfg), config={
        "train_batch_size": 4, "steps_per_print": 0, "bf16": {"enabled": True},
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
        "checkpoint": {"async_save": False}})
    engine.train_batch(gpt2.synthetic_lm_batch(4, 128, 1024, device="cuda"))
    engine.save_checkpoint(str(tmp_path))
    served = deepspeed_tpu_torch.init_inference(
        gpt2.GPT2Model(dataclasses.replace(cfg, use_flash_decode=True)),
        config={"checkpoint": str(tmp_path), "dtype": "bfloat16", "max_out_tokens": 256})
    tag = read_state(str(tmp_path / "global_step1"), ("params",), "cpu")
    for name, p in served.module.named_parameters():
        assert torch.equal(p.cpu(), tag[f"params/{name}"].to(torch.bfloat16)), name
    ids = torch.randint(0, 1024, (3, 100), generator=gen, device="cuda")
    fa0, da0 = tfa.KERNEL.launches, tda.KERNEL.launches
    out = served.generate(ids, max_new_tokens=40)
    assert (tfa.KERNEL.launches - fa0, tda.KERNEL.launches - da0) == (2, 2 * 41)
    assert torch.equal(out, _eager_loop(served, ids, 40))


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


# ------------------------------------------------- llama and BERT training
@pytest.mark.parametrize("BH,T,causal,dtype", [
    (128, 2048, True, torch.bfloat16),       # llama3.2-1b, 4 x 2048, 32 heads
    (1024, 128, False, torch.bfloat16), (1024, 128, False, torch.float16),   # bert-large
    (256, 512, False, torch.bfloat16), (256, 512, False, torch.float16)])
def test_flash_kernels_at_the_llama_and_bert_training_shapes(gen, BH, T, causal, dtype):
    _flash_kernels(gen, BH, T, T, 64, dtype, causal)


def _model_step(model, batch):
    """One loss and the gradients by name (a weight the loss does not use,
    a MoE model's odd-block MLP, has none and is left out)."""
    model.zero_grad(set_to_none=True)
    loss = model.loss(batch)
    loss.backward()
    return loss.detach().float(), {n: p.grad.float() for n, p in model.named_parameters()
                                   if p.grad is not None}


def _kernel_vs_plain(model, batch):
    """One step's loss and gradients on the kernel path, its launches, and
    the plain path's on the same weights (the model's own flag)."""
    tfa.KERNEL.reset_launches()
    tfa.BWD_KERNEL.reset_launches()
    loss_k, grads_k = _model_step(model, batch)
    launches = (tfa.KERNEL.launches, tfa.BWD_KERNEL.entry_launches["flash_attention_bwd_dq"],
                tfa.BWD_KERNEL.entry_launches["flash_attention_bwd_dkv"])
    model.config = dataclasses.replace(model.config, use_flash_attention=False)
    loss_p, grads_p = _model_step(model, batch)
    model.config = dataclasses.replace(model.config, use_flash_attention=True)
    rel = {n: ((grads_k[n] - grads_p[n]).norm() / grads_p[n].norm().clamp_min(1e-30)).item()
           for n in grads_k}
    return launches, abs(loss_k.item() - loss_p.item()) / loss_p.item(), max(rel.values())


def test_bert_step_runs_the_noncausal_kernels(gen):
    """A 2-layer bf16 BERT: each layer launches K1 and each K2 entry once,
    non-causal (the plain path, bidirectional, agrees: loss 1%, gradients
    10% in L2); with an attention_mask no kernel runs and the two paths
    are the same path."""
    from deepspeed_tpu_torch.models import bert

    cfg = bert.BertConfig(vocab_size=1024, n_positions=128, n_embd=256, n_layer=2, n_head=4,
                          max_predictions_per_seq=20)
    model = bert.BertModel(cfg).init_params(gen).to(torch.bfloat16)
    batch = bert.synthetic_mlm_batch(8, 128, cfg.vocab_size, max_predictions=20, device="cuda")
    launches, loss_rel, grad_rel = _kernel_vs_plain(model, batch)
    assert launches == (2, 2, 2) and loss_rel <= 1e-2 and grad_rel <= 1e-1
    masked = {**batch, "attention_mask": torch.ones_like(batch["input_ids"])}
    masked["attention_mask"][:, 100:] = 0
    launches, loss_rel, grad_rel = _kernel_vs_plain(model, masked)
    assert launches == (0, 0, 0) and loss_rel == 0.0 and grad_rel == 0.0


def test_bert_fp16_train_batch_runs_the_kernels(gen):
    from deepspeed_tpu_torch.models import bert

    cfg = bert.BertConfig(vocab_size=1024, n_positions=128, n_embd=256, n_layer=2, n_head=4,
                          dtype=torch.float16)
    engine, *_ = deepspeed_tpu_torch.initialize(model=bert.BertModel(cfg), config={
        "train_batch_size": 8, "gradient_clipping": 1.0, "steps_per_print": 0,
        "fp16": {"enabled": True, "initial_scale_power": 8},
        "optimizer": {"type": "Lamb", "params": {"lr": 1e-3, "weight_decay": 0.01}}})
    batch = bert.synthetic_mlm_batch(8, 128, cfg.vocab_size, device="cuda")
    tfa.KERNEL.reset_launches()
    tfa.BWD_KERNEL.reset_launches()
    losses = [float(engine.train_batch(batch)) for _ in range(3)]
    assert (tfa.KERNEL.launches, tfa.BWD_KERNEL.launches) == (6, 12)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] and engine.skipped_steps == 0


def test_llama_grouped_kv_step_runs_the_kernels(gen):
    """A 2-layer bf16 llama with 4 query heads per KV head under remat:
    K1 twice per layer (the forward and its recompute), each K2 entry
    once, and the plain path agrees (loss 1%, gradients 10% in L2)."""
    from deepspeed_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(vocab_size=1024, n_positions=256, n_embd=256, n_layer=2, n_head=8,
                      n_kv_head=2, intermediate_size=512, tie_embeddings=True, remat="full")
    model = LlamaModel(cfg).init_params(gen).to(torch.bfloat16)
    batch = gpt2.synthetic_lm_batch(4, 256, cfg.vocab_size, device="cuda")
    launches, loss_rel, grad_rel = _kernel_vs_plain(model, batch)
    assert launches == (4, 2, 2) and loss_rel <= 1e-2 and grad_rel <= 1e-1


# ------------------------------------------------------------------- MoE
def _moe_model(gen, dtype, **over):
    from deepspeed_tpu_torch.models.gpt2_moe import MoEGPT2

    cfg = gpt2.GPT2Config(vocab_size=1024, n_positions=256, n_embd=256, n_layer=4, n_head=4,
                          dtype=dtype, **over)
    return MoEGPT2(cfg, num_experts=8).init_params(gen).to(dtype)


def test_flash_kernels_at_the_moe_training_shape(gen):
    _flash_kernels(gen, 12 * 12, 1024, 1024, 64, torch.bfloat16, True)   # gpt2-moe-125m


def test_moe_step_runs_the_kernels(gen):
    """A 4-layer bf16 MoE GPT-2 (two dense/MoE pairs, 8 experts, top-1)
    under remat per pair: K1 twice per layer, each K2 entry once, the
    plain path agreeing (loss 1%, gradients 10% in L2) when it routes as
    the kernel path did (``MOELayer.pinned``: a token the two roundings
    send to another expert moves the gate's gradient by more than the
    kernels do), and the odd blocks' MLP weights without a gradient."""
    model = _moe_model(gen, torch.bfloat16, remat="full")
    batch = gpt2.synthetic_lm_batch(4, 256, 1024, device="cuda")
    layers = [layer.moe_layer for layer in model.moe]
    for layer in layers:
        layer.record = True
    _model_step(model, batch)
    for layer in layers:
        layer.record, layer.pinned = False, layer.routing
    launches, loss_rel, grad_rel = _kernel_vs_plain(model, batch)
    assert launches == (8, 4, 4) and loss_rel <= 1e-2 and grad_rel <= 1e-1
    for layer in layers:
        layer.pinned = None
    _, grads = _model_step(model, batch)
    assert not {n for n in grads if n.startswith(("blocks.1.fc", "blocks.3.fc"))}


def test_moe_graphed_decode_equals_the_eager_loop(gen):
    """The MoE decode step (gate, dispatch, experts, combine) captured in
    the decode graph gives the eager loop's greedy tokens."""
    model = _moe_model(gen, torch.bfloat16, use_flash_decode=True)
    eng = deepspeed_tpu_torch.init_inference(model, {"dtype": "bfloat16",
                                                     "max_out_tokens": 256})
    ids = torch.randint(0, 1024, (16, 40), generator=gen, device="cuda")
    out = eng.generate(ids, max_new_tokens=24)
    again = eng.generate(ids, max_new_tokens=24)
    assert torch.equal(out, again) and torch.equal(out, _eager_loop(eng, ids, 24))


# ------------------------------------------------- the GPT-2 variant families
# (family, switches, layers that reach the kernels): GPT-J at head dim 256
# (d 512, 2 heads), GPT-Neo's global layers only, BLOOM's ALiBi none
VARIANT_FAMILIES = [
    ("gptj", dict(n_embd=512, n_head=2, rotary_pct=0.25, rotary_interleaved=True,
                  parallel_residual=True, tie_embeddings=False, lm_head_bias=True), 2),
    ("gpt_neox", dict(rotary_pct=0.25, parallel_residual=True, tie_embeddings=False), 2),
    ("opt", dict(activation="relu"), 2),
    ("gpt_neo", dict(attention_layers=("global", "local"), window_size=32), 1),
    ("bloom", dict(n_head=6, n_embd=384, alibi=True, embed_layernorm=True), 0)]


@pytest.mark.parametrize("family,switches,kernel_layers", VARIANT_FAMILIES)
def test_variant_families_serve_graphed_through_the_kernels(gen, family, switches,
                                                            kernel_layers):
    """2-layer bf16 models of each family: the graphed generate gives the
    eager loop's greedy tokens (GPT-Neo past its 32-slot window); K1 once
    per kernel layer a prefill and K3 once per kernel layer a step, none
    for a local or ALiBi layer; the prefill's logits within 5e-2 of the
    plain path's largest on the same weights."""
    kw = dict(vocab_size=1024, n_positions=256, n_embd=256, n_layer=2, n_head=4,
              use_flash_decode=True, dtype=torch.bfloat16)
    cfg = gpt2.GPT2Config(**{**kw, **switches})
    model = gpt2.GPT2Model(cfg).init_params(gen)
    eng = deepspeed_tpu_torch.init_inference(model, {"dtype": "bfloat16", "max_out_tokens": 256})
    ids = torch.randint(0, 1024, (4, 48), generator=gen, device="cuda")
    first = eng.generate(ids, max_new_tokens=24)           # captures after a warm-up step
    tfa.KERNEL.reset_launches()
    tda.KERNEL.reset_launches()
    out = eng.generate(ids, max_new_tokens=24)             # replays the same graph
    assert torch.equal(out, first)
    assert (tfa.KERNEL.launches, tda.KERNEL.launches) == (kernel_layers, kernel_layers * 24)
    assert torch.equal(out, _eager_loop(eng, ids, 24))
    plain = gpt2.GPT2Model(dataclasses.replace(cfg, use_flash_attention=False,
                                               use_flash_decode=False))
    plain.load_state_dict(eng.module.state_dict(), assign=True)
    with torch.inference_mode():
        got, _ = eng.module.prefill(ids, eng.module.init_cache(4, 64))
        ref, _ = plain.prefill(ids, plain.init_cache(4, 64))
    assert (got.float() - ref.float()).abs().max().item() <= 5e-2 * ref.float().abs().max().item()


@pytest.mark.parametrize("remat,k1_per_layer", [("attn", 1), ("attn_mlp", 1), ("full", 2),
                                                ("dots", 2), (False, 1)])
def test_remat_policy_launches_per_step(gen, remat, k1_per_layer):
    """A 2-layer bf16 NeoX-style GPT-2 step: "attn" and "attn_mlp" keep K1's
    outputs, so the recompute does not launch it; "full" and "dots" launch
    it again; each K2 entry once per layer under every policy. The loss
    equals remat off's bit for bit (the same kernels on the same values)."""
    cfg = gpt2.GPT2Config(vocab_size=1024, n_positions=256, n_embd=256, n_layer=2, n_head=2,
                          rotary_pct=0.25, parallel_residual=True, remat=remat,
                          dtype=torch.bfloat16)
    model = gpt2.GPT2Model(cfg).init_params(gen).to(torch.bfloat16)
    batch = gpt2.synthetic_lm_batch(2, 256, 1024, device="cuda")
    tfa.KERNEL.reset_launches()
    tfa.BWD_KERNEL.reset_launches()
    loss, _ = _model_step(model, batch)
    assert tfa.KERNEL.launches == 2 * k1_per_layer
    assert tfa.BWD_KERNEL.entry_launches == {"flash_attention_bwd_dq": 2,
                                             "flash_attention_bwd_dkv": 2}
    model.config = dataclasses.replace(cfg, remat=False)
    ref, _ = _model_step(model, batch)
    assert torch.equal(loss, ref)


def test_dropout_under_remat_attn_equals_remat_off_on_the_card(gen):
    """fp32, dropout 0.1: the same generator seed gives the same masks in
    the recompute, so the gradients under remat "attn" equal remat off's
    (1e-6 of each tensor's norm)."""
    cfg = gpt2.GPT2Config(vocab_size=1024, n_positions=256, n_embd=256, n_layer=2, n_head=2,
                          rotary_pct=0.25, parallel_residual=True, dropout=0.1, remat="attn",
                          dtype=torch.float32)
    model = gpt2.GPT2Model(cfg).init_params(gen)
    batch = gpt2.synthetic_lm_batch(2, 128, 1024, device="cuda")
    grads = []
    for remat in ("attn", False):
        model.config = dataclasses.replace(cfg, remat=remat)
        model.zero_grad(set_to_none=True)
        model.loss(batch, generator=torch.Generator(device="cuda").manual_seed(5)).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for n, g in grads[0].items():
        assert (g - grads[1][n]).norm().item() <= 1e-6 * grads[1][n].norm().item(), n


# ------------------------------------------------------------ model import
def test_imported_llama_serves_through_the_kernels(gen):
    """llama3.2-1b's widths at 2 layers: the port's own bf16 weights exported
    to HF's layout (``export_llama``) and imported by ``load_hf_model`` (a
    dict config) come back bit for bit; served in bf16, the graphed generate
    launches K1 once per layer and K3 once per layer and step, gives the
    eager loop's tokens and the port's own model's tokens, and its prefill
    logits are within 5e-2 of the plain path's largest."""
    from deepspeed_tpu_torch.module_inject import hf

    cfg = dataclasses.replace(PRESETS["llama3.2-1b"], n_layer=2, remat=False,
                              use_flash_decode=True)
    own = LlamaModel(cfg).init_params(gen).to(torch.bfloat16)
    config = {"model_type": "llama", "num_attention_heads": cfg.n_head,
              "rope_theta": cfg.rope_theta, "rope_scaling": cfg.rope_scaling,
              "max_position_embeddings": cfg.n_positions, "rms_norm_eps": cfg.rms_norm_eps}
    model, params = hf.load_hf_model(types.SimpleNamespace(
        config=config, state_dict=lambda: hf.export_llama(own)), dtype=torch.bfloat16)
    for name, t in own.state_dict().items():
        assert torch.equal(params[name], t.cpu()), name
    assert model.config.n_kv_head == cfg.n_kv_head and model.config.tie_embeddings
    eng = deepspeed_tpu_torch.init_inference(
        LlamaModel(dataclasses.replace(model.config, use_flash_decode=True)),
        {"dtype": "bfloat16", "max_out_tokens": 256}, params=params)
    ref_eng = deepspeed_tpu_torch.init_inference(own, {"dtype": "bfloat16", "max_out_tokens": 256})
    ids = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen, device="cuda")
    first = eng.generate(ids, max_new_tokens=24)
    tfa.KERNEL.reset_launches()
    tda.KERNEL.reset_launches()
    out = eng.generate(ids, max_new_tokens=24)
    assert (tfa.KERNEL.launches, tda.KERNEL.launches) == (2, 2 * 24)
    assert torch.equal(out, first) and torch.equal(out, _eager_loop(eng, ids, 24))
    assert torch.equal(out, ref_eng.generate(ids, max_new_tokens=24))
    plain = LlamaModel(dataclasses.replace(model.config, use_flash_attention=False))
    plain.load_state_dict(eng.module.state_dict(), assign=True)
    with torch.inference_mode():
        got, _ = eng.module.prefill(ids, eng.module.init_cache(4, 64))
        ref, _ = plain.prefill(ids, plain.init_cache(4, 64))
    assert (got.float() - ref.float()).abs().max().item() <= 5e-2 * ref.float().abs().max().item()


def test_megatron_dir_serves_greedy_like_its_state_dict(gen, tmp_path):
    """gpt2-760m's widths at 2 layers written as a Megatron-DeepSpeed
    directory (fp16, tp 2) and served by ``init_inference(model=None,
    checkpoint=..., checkpoint_config={"type": "Megatron", "n_head": 16})``
    in bf16: the files' weights bit for bit, one K1 per layer a prefill and
    one K3 per layer a step, and the greedy tokens of the same weights
    served from the port's state dict."""
    from tests.torch_megatron_files import write_megatron

    cfg = dataclasses.replace(gpt2.PRESETS["gpt2-760m"], n_layer=2, remat=False)
    sd = {k: v.to(torch.float16).cpu()
          for k, v in gpt2.GPT2Model(cfg).init_params(gen).state_dict().items()}
    write_megatron(sd, cfg.n_layer, cfg.n_head, str(tmp_path), tp=2)
    served = deepspeed_tpu_torch.init_inference(config={
        "checkpoint": str(tmp_path), "dtype": "bfloat16", "max_out_tokens": 256,
        "checkpoint_config": {"type": "Megatron", "n_head": cfg.n_head}})
    want = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    for name, p in served.module.state_dict().items():
        assert torch.equal(p.cpu(), want[name]), name
    direct = deepspeed_tpu_torch.init_inference(
        gpt2.GPT2Model(dataclasses.replace(cfg, use_flash_decode=True)),
        {"dtype": "bfloat16", "max_out_tokens": 256}, params=want)
    ids = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen, device="cuda")
    tfa.KERNEL.reset_launches()
    tda.KERNEL.reset_launches()
    out = served.generate(ids, max_new_tokens=32)
    assert (tfa.KERNEL.launches, tda.KERNEL.launches) == (2, 2 * 33)
    assert torch.equal(out, direct.generate(ids, max_new_tokens=32))
    assert torch.equal(out, _eager_loop(served, ids, 32))


# ----------------------------------------------- the switches of one card
def _llama_small(gen, **over):
    cfg = dataclasses.replace(PRESETS["llama-tiny"], n_embd=256, n_head=4, n_kv_head=2,
                              intermediate_size=512, vocab_size=1024, n_positions=256,
                              use_flash_decode=True, **over)
    return LlamaModel(cfg).init_params(gen)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_llama_serves_graphed_like_its_dequantized_weights(gen, bits):
    """int8/int4 weights dequantized per block inside the captured decode
    step: the graphed tokens equal the eager loop's and those of the same
    model served in bf16 from the dequantized weights; the codes, not the
    bf16 weights, are what the engine holds."""
    from deepspeed_tpu_torch.ops.quantizer import dequantize_params

    model = _llama_small(gen)
    eng = deepspeed_tpu_torch.init_inference(model, {"max_out_tokens": 128}, dtype=torch.int8,
                                             quant={"weight": {"num_bits": bits,
                                                               "quantized_initialization":
                                                                   {"min_numel": 4096}}})
    assert eng.quantized and all(q.q.is_cuda for q in eng.quantized.values())
    ids = torch.randint(0, 1024, (8, 24), generator=gen, device="cuda")
    tda.KERNEL.reset_launches()
    out = eng.generate(ids, max_new_tokens=16)
    assert tda.KERNEL.launches == 2 * 17                       # 2 layers, warm-up included
    assert torch.equal(out, _eager_loop(eng, ids, 16))
    dense = {n: p for n, p in model.named_parameters() if not p.is_meta}
    dense.update(dequantize_params(eng.quantized, torch.bfloat16))
    ref_model = LlamaModel(model.config)
    ref_model.load_state_dict(dense, assign=True)
    ref = deepspeed_tpu_torch.init_inference(ref_model, {"dtype": "bf16", "max_out_tokens": 128})
    assert torch.equal(ref.generate(ids, max_new_tokens=16), out)
    assert eng.weight_nbytes() < ref.weight_nbytes()


def test_cpu_checkpointing_keeps_pinned_host_copies_on_the_card(gen):
    """``cpu_checkpointing`` on the card: the kept matmul outputs are pinned
    host tensors, read back in the recompute, and the gradients are the
    plain path's bit for bit."""
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing

    cfg = gpt2.GPT2Config(vocab_size=1024, n_positions=256, n_embd=256, n_layer=2, n_head=4,
                          dtype=torch.bfloat16, remat=False)
    model = gpt2.GPT2Model(cfg).init_params(gen).to(torch.bfloat16)
    x = torch.randn(4, 128, 256, generator=gen, device="cuda", dtype=torch.bfloat16)
    store = []
    grads = []
    for keep in (True, False):
        h = x.clone().requires_grad_()
        fn = lambda t: model._block(t, model.blocks[0], 0, None)
        out = torch.utils.checkpoint.checkpoint(
            fn, h, use_reentrant=False,
            context_fn=lambda: checkpointing.offload_contexts(store)) if keep else fn(h)
        out.float().square().sum().backward()
        grads.append(h.grad)
    assert len(store) == 4 and all(t.device.type == "cpu" and t.is_pinned() for t in store)
    assert torch.equal(grads[0], grads[1])


def test_sparse_moe_step_runs_the_sparse_kernels(gen):
    """A 4-layer bf16 MoE GPT-2 with a fixed block-16 layout under remat per
    pair: K4a twice per layer (forward and recompute), K4b and K4c once, no
    dense kernel; a finite loss."""
    model = _moe_model(gen, torch.bfloat16, remat="full",
                       sparse_attention={"mode": "fixed", "block": 16, "num_local_blocks": 2})
    batch = gpt2.synthetic_lm_batch(2, 256, 1024, device="cuda")
    tfa.SPARSE_KERNEL.reset_launches()
    tfa.KERNEL.reset_launches()
    loss, grads = _model_step(model, batch)
    assert tfa.SPARSE_KERNEL.entry_launches == {"sparse_attention_fwd": 8,
                                                "sparse_attention_bwd_dq": 4,
                                                "sparse_attention_bwd_dkv": 4}
    assert tfa.KERNEL.launches == 0 and torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads.values())


def test_random_ltd_ops_on_the_card_equal_the_cpu(gen):
    from deepspeed_tpu_torch.runtime.data_pipeline import data_routing as dr

    idx = dr.random_ltd_sample(torch.Generator(device="cuda").manual_seed(3), 64, 20, 4)
    assert idx.is_cuda and idx.shape == (4, 20)
    x = torch.randn(4, 64, 32, generator=gen, device="cuda")
    small = dr.random_ltd_gather(x, idx)
    back = dr.random_ltd_scatter(small * 2, idx, x)
    assert torch.equal(small.cpu(), dr.random_ltd_gather(x.cpu(), idx.cpu()))
    assert torch.equal(back.cpu(), dr.random_ltd_scatter(small.cpu() * 2, idx.cpu(), x.cpu()))


# ------------------------------------------------------------- RLHF actor
_MOQ = {"weight_quantization": {
    "shared_parameters": {"enabled": True, "schedule_offset": 1, "quantization_period": 1},
    "different_groups": {"q": {"params": {"start_bits": 8, "target_bits": 6},
                               "modules": ["blocks"]}}}}


def _hybrid_gpt2(**extra):
    cfg = gpt2.GPT2Config(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2,
                          remat=False, use_flash_decode=True, dtype=torch.bfloat16)
    config = {"train_batch_size": 4, "steps_per_print": 0, "bf16": {"enabled": True},
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}},
              "hybrid_engine": {"enabled": True, "max_out_tokens": 128}, **extra}
    engine, *_ = deepspeed_tpu_torch.initialize(model=gpt2.GPT2Model(cfg), config=config)
    return engine


@pytest.mark.parametrize("extra", [
    {}, {"zero_optimization": {"stage": 2}},
    {"zero_optimization": {"stage": 3, "stage3_param_persistence_threshold": 0}},
    {"compression_training": _MOQ}], ids=["stage0", "stage2", "stage3", "moq"])
def test_hybrid_replay_reads_params_updated_in_place(gen, extra):
    """The hybrid engine's one captured decode graph, replayed after each
    step, gives the eager loop's tokens on the updated params: the step
    writes the params in place (stages 0-2), the stage-3 gathers copy from
    partitions written in place, and MoQ's compressed weights are rewritten
    into the same buffers for each step."""
    eng = _hybrid_gpt2(**extra)
    ids = torch.randint(0, 512, (4, 16), generator=torch.Generator(device="cuda")
                        .manual_seed(1), device="cuda")
    ptrs = [p.data_ptr() for p in eng.module.parameters()]
    outs = []
    for _ in range(3):
        out = eng.generate(ids, max_new_tokens=32)
        assert torch.equal(out, _eager_loop(eng, ids, 32))
        outs.append(out)
        eng.train_batch({"input_ids": out})
    assert [p.data_ptr() for p in eng.module.parameters()] == ptrs
    assert eng.hybrid_stats()["captures"] == 1 and len(eng._decode_loops) == 1
    assert not all(torch.equal(outs[0], o) for o in outs[1:])


def test_compression_ops_on_the_card_equal_the_cpu(gen):
    from deepspeed_tpu_torch.compression import basic_ops as ops

    w = torch.randn(3, 64, 96, generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        x = w.to(dtype)
        for bits, groups, sym in ((8, 1, True), (4, 5, False)):
            assert torch.equal(ops.fake_quantize_values(x, bits, groups, sym, False).cpu(),
                               ops.fake_quantize_values(x.cpu(), bits, groups, sym, False))
    for ratio in (0.5, 0.3):
        assert torch.equal(ops.topk_mask(w.abs(), ratio).cpu(), ops.topk_mask(w.abs().cpu(), ratio))
        assert torch.equal(ops.head_prune(w, 4, ratio).cpu(), ops.head_prune(w.cpu(), 4, ratio))
        assert torch.equal(ops.row_prune(w, ratio).cpu(), ops.row_prune(w.cpu(), ratio))
    sto = ops.fake_quantize_values(w, 4, 1, True, True)
    scale = w.abs().max() / 7
    assert torch.allclose(sto / scale, torch.round(sto / scale), atol=1e-4)
    assert (ops.fake_quantize_values(w, 4, 1, True, False) - sto).abs().max() <= scale * 1.0001


def test_eigenvalue_estimate_launches_no_kernel(gen):
    """The Hessian-vector products run the plain attention: the estimate
    launches no K1 or K2, the train step its own."""
    cfg = gpt2.GPT2Config(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2,
                          remat=False, dtype=torch.bfloat16)
    engine, *_ = deepspeed_tpu_torch.initialize(model=gpt2.GPT2Model(cfg), config={
        "train_batch_size": 4, "steps_per_print": 0, "bf16": {"enabled": True},
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
        "compression_training": _MOQ, "eigenvalue": {"enabled": True, "max_iter": 4}})
    seen = {}
    estimate = engine._maybe_update_eigenvalue

    def counted(batch):
        seen["step"] = (tfa.KERNEL.launches, tfa.BWD_KERNEL.launches)
        estimate(batch)
        seen["estimate"] = (tfa.KERNEL.launches - seen["step"][0],
                            tfa.BWD_KERNEL.launches - seen["step"][1])

    engine._maybe_update_eigenvalue = counted
    fwd0, bwd0 = tfa.KERNEL.launches, tfa.BWD_KERNEL.launches
    engine.train_batch({"input_ids": torch.randint(0, 512, (4, 64), generator=gen,
                                                   device="cuda")})
    assert seen["estimate"] == (0, 0)
    assert seen["step"][0] - fwd0 == 2 and seen["step"][1] > bwd0
    assert engine.block_eigenvalue and engine._compression._ev_factors


def _card_frontend(eng, **serving):
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.serving import ServingFrontEnd

    block = {"decode_tick_tokens": 8, "max_queue_depth": 8, **serving}
    return ServingFrontEnd(eng, DeepSpeedConfig({"serving": block}).serving)


def _join_serving_ticks():
    from deepspeed_tpu_torch.utils import locks

    for rec in locks.framework_threads():
        if rec.name.startswith("ds-deadline-serve-tick"):
            rec.thread.join(30.0)


def test_frontend_serves_generate_tokens_on_the_card(gen):
    """A small llama behind the serving front-end: each request's B = 1
    loop over a cache of max_out_tokens, captured on the tick thread, gives
    generate's tokens, greedy and sampled; one K1 per layer per prompt, one
    K3 per layer per token and per layer for the capture's warm-up step."""
    eng = _graph_engine(gen, torch.bfloat16)
    prompts = [torch.randint(0, 512, (1, t), generator=gen, device="cuda").cpu().numpy()
               for t in (5, 40, 120)]
    new = (24, 64, 100)
    fe = _card_frontend(eng)
    try:
        fa0, da0 = tfa.KERNEL.launches, tda.KERNEL.launches
        reqs = [fe.submit(p, max_new_tokens=n) for p, n in zip(prompts, new)]
        for r in reqs:
            r.result(timeout=300)
        counts = (tfa.KERNEL.launches - fa0, tda.KERNEL.launches - da0)
        sample = dict(do_sample=True, top_k=50, top_p=0.9, seed=7)
        sampled = fe.submit(prompts[1], max_new_tokens=32, **sample).result(timeout=300)
    finally:
        fe.close()
        _join_serving_ticks()
    assert [r.status for r in reqs] == ["completed"] * 3 and sampled.status == "completed"
    assert counts == (2 * 3, 2 * (sum(new) + 1))
    for r, p in zip(reqs, prompts):
        ref = eng.generate(p, max_new_tokens=len(r.tokens))[0, p.shape[1]:].tolist()
        assert r.tokens == ref
    ref = eng.generate(prompts[1], max_new_tokens=32, **sample)[0, 40:].tolist()
    assert sampled.tokens == ref


def test_frontend_hung_tick_then_requests_equal_generate(gen):
    """A chaos hang on a decode tick times out against the warm tick cap;
    the key's loop is dropped, so the request served while the disowned
    tick sleeps, and the one after it wakes, give generate's tokens."""
    import time

    from deepspeed_tpu_torch.resilience.chaos import (ChaosInjector, install_chaos,
                                                      uninstall_chaos)

    eng = _graph_engine(gen, torch.bfloat16)
    prompts = [torch.randint(0, 512, (1, 32), generator=gen, device="cuda").cpu().numpy()
               for _ in range(4)]
    fe = _card_frontend(eng, decode_tick_timeout_s=0.5)
    try:
        assert fe.submit(prompts[0], max_new_tokens=32).result(timeout=300).status == \
            "completed"
        install_chaos(ChaosInjector(hang_at={"decode_step": [3]}, hang_s=2.0))
        hung = fe.submit(prompts[1], max_new_tokens=48).result(timeout=60)
        uninstall_chaos()
        during = fe.submit(prompts[2], max_new_tokens=48).result(timeout=300)
        time.sleep(2.0)
        after = fe.submit(prompts[3], max_new_tokens=48).result(timeout=300)
        state = fe.state
    finally:
        uninstall_chaos()
        fe.close()
        _join_serving_ticks()
    assert (hung.status, hung.reason, len(hung.tokens)) == ("partial", "timeout", 8)
    assert state == "ready"
    for r, p in ((during, prompts[2]), (after, prompts[3])):
        assert r.status == "completed"
        assert r.tokens == eng.generate(p, max_new_tokens=48)[0, 32:].tolist()


# --------------------------------------------------- the resilient training run
def _armed_config(tmp_path):
    return {**RESUME_CONFIG,
            "watchdog": {"enabled": True, "heartbeat_file": str(tmp_path / "hb"),
                         "consistency_interval": 1},
            "resilience": {"sentinel": {"enabled": True}},
            "rewind": {"ram_interval": 2, "keep": 2}}


def test_armed_step_equals_the_unarmed_step_bit_for_bit(gen, tmp_path):
    """The watchdog (heartbeat, the step agreement every step), the
    sentinel and the RAM ring change no bit of a bf16 step on the card, and
    the steps still run the kernels once per layer."""
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch
    from deepspeed_tpu_torch.resilience import rewind as rw
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import flatten_state

    batch = synthetic_lm_batch(4, 128, 1024, seed=3, device="cuda")
    runs = []
    try:
        for config in (dict(RESUME_CONFIG), _armed_config(tmp_path)):
            eng, *_ = deepspeed_tpu_torch.initialize(model=_resume_model(), config=config)
            before = tfa.KERNEL.launches
            losses = [float(eng.train_batch(batch)) for _ in range(5)]
            assert tfa.KERNEL.launches - before == 2 * 5
            runs.append((losses, {k: _bits(v) for k, v in flatten_state(eng).items()}))
            if eng._watchdog is not None:
                assert [s.step for s in rw.ram_snapshots()] == [2, 4]
                assert os.path.isfile(tmp_path / "hb")
                eng._watchdog.close()
    finally:
        rw.clear_ram_snapshots()
    assert runs[0][0] == runs[1][0]
    assert runs[0][1].keys() == runs[1][1].keys()
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])


def test_ram_snapshot_roundtrips_on_the_card(gen, tmp_path):
    """A snapshot in page-locked host memory restores the card's state bit
    for bit, and the steps after it equal the steps after the snapshot."""
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch
    from deepspeed_tpu_torch.resilience import rewind as rw
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import flatten_state

    batch = synthetic_lm_batch(4, 128, 1024, seed=4, device="cuda")
    try:
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=_resume_model(), config={**RESUME_CONFIG,
                                           "rewind": {"ram_interval": 1000, "keep": 1}})
        for _ in range(2):
            eng.train_batch(batch)
        snap = eng._rewind.snapshot_now()
        assert snap.step == 2 and snap.slot.pinned and rw.ram_snapshots() == [snap]
        want = {k: _bits(v) for k, v in flatten_state(eng).items()}
        after = [float(eng.train_batch(batch)) for _ in range(2)]
        info = eng._rewind.restore_from_ram()
        assert info["tier"] == "ram" and eng.global_steps == 2
        got = {k: _bits(v) for k, v in flatten_state(eng).items()}
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert [float(eng.train_batch(batch)) for _ in range(2)] == after
    finally:
        rw.clear_ram_snapshots()


# -------------------------------------------------- monitoring and profiling
def test_flops_count_on_the_card_equals_the_cpu_count(gen, tmp_path):
    """The flops profiler's count of a bf16 step through K1/K2 on the card
    equals the count of the same step on the CPU (the plain attention),
    scope by scope: the attention ops report the einsum formula whichever
    body runs. The profiled step launches K1 and each K2 entry once a layer."""
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    config = {**RESUME_CONFIG, "flops_profiler": {"enabled": True, "profile_step": 2},
              "csv_monitor": {"enabled": True, "output_path": str(tmp_path)}}
    profiles = {}
    for device in ("cuda", "cpu"):
        eng, *_ = deepspeed_tpu_torch.initialize(model=_resume_model(), config=dict(config),
                                                 device=device)
        batch = synthetic_lm_batch(4, 128, 1024, seed=5, device=device)
        eng.train_batch(batch)
        before = (tfa.KERNEL.launches, dict(tfa.BWD_KERNEL.entry_launches))
        eng.train_batch(batch)
        if device == "cuda":
            assert tfa.KERNEL.launches - before[0] == 2
            assert {k: v - before[1].get(k, 0) for k, v in tfa.BWD_KERNEL.entry_launches.items()} \
                == {"flash_attention_bwd_dq": 2, "flash_attention_bwd_dkv": 2}
        profiles[device] = (eng.flops_profile.flops, eng.flops_profile.per_scope,
                            eng.tput_timer.flops_per_batch)
        eng.monitor.csv_monitor.close()
    assert profiles["cuda"] == profiles["cpu"]
    assert profiles["cuda"][0] > 0


def test_census_total_is_the_allocators_on_the_card(gen, tmp_path):
    """The census total is ``torch.cuda.memory_allocated()``; the params,
    masters and Adam moments hold 2, 4 and 8 bytes a parameter; the
    train_batch span records its peak above its entry."""
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    config = {**RESUME_CONFIG, "profiling": {"sample_interval": 1},
              "telemetry": {"enabled": True, "output_dir": str(tmp_path), "flush_interval": 100}}
    try:
        eng, *_ = deepspeed_tpu_torch.initialize(model=_resume_model(), config=config)
        eng.train_batch(synthetic_lm_batch(4, 128, 1024, seed=6, device="cuda"))
        res = eng.memory_census()
        assert res.total_bytes == torch.cuda.memory_allocated()
        n = sum(p.numel() for p in eng.module.parameters())
        assert (res.bucket_bytes["params"], res.bucket_bytes["master"],
                res.bucket_bytes["optimizer_state"]) == (2 * n, 4 * n, 8 * n)
        assert res.other_bytes == res.total_bytes - res.attributed_bytes >= 0
        snap = {(r["name"], tuple(sorted(r["labels"].items()))): r
                for r in telemetry.get_registry().snapshot()}
        peak = snap[("profiling/span_peak_bytes", (("span", "train_batch"),))]
        assert peak["count"] == 1 and peak["max"] > 0
        assert snap[("profiling/live_bytes_total", ())]["value"] > 0
    finally:
        telemetry.deconfigure()


# ------------------------------------- compression under ZeRO-3 and goodput
_PRUNED_MOQ = {**_MOQ, "sparse_pruning": {
    "shared_parameters": {"enabled": True, "schedule_offset": 2, "method": "l1"},
    "different_groups": {"p": {"params": {"dense_ratio": 0.5}, "modules": ["blocks"]}}}}


@pytest.mark.parametrize("zero", [
    {"stage": 3, "stage3_param_persistence_threshold": 0},
    {"stage": 3, "stage3_param_persistence_threshold": 0, "offload_param": {"device": "cpu"}}],
    ids=["stage3", "stage3_offload"])
def test_stage3_refresh_serves_the_stage1_values_on_the_card(gen, zero):
    """A bf16 GPT-2's compressed weights at a quantized and pruned step:
    what the stage-3 units' gathers hand out (served from the card, or from
    pinned host memory under offload_param) equals the stage-1 refresh's
    buffers bit for bit."""
    cfg = gpt2.GPT2Config(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2,
                          remat=False, dtype=torch.bfloat16)
    init = gpt2.GPT2Model(cfg).init_params(torch.Generator(device="cuda").manual_seed(3))
    state = {n: t.detach().clone() for n, t in init.state_dict().items()}
    engines = {}
    for name, z in (("stage1", {"stage": 1}), ("fetched", zero)):
        engines[name], *_ = deepspeed_tpu_torch.initialize(
            model=gpt2.GPT2Model(cfg), model_parameters=dict(state), config={
                "train_batch_size": 4, "steps_per_print": 0, "bf16": {"enabled": True},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
                "compression_training": _PRUNED_MOQ, "zero_optimization": z})
        engines[name]._compressed.refresh(3)
    ref, z3 = engines["stage1"]._compressed, engines["fetched"]._zero
    assert z3.served and all(t.is_pinned() == ("offload_param" in zero)
                             for t in z3.served.values())
    index = {n: i for i, n in enumerate(engines["fetched"]._param_names)}
    for name, want in ref.eff.items():
        p = z3.plan.params[index[name]]
        whole = z3._gather(p.unit, live=False, served=True)
        got = whole[p.offset:p.offset + p.numel].view(p.shape)
        assert torch.equal(got, want), name
    assert len(ref.eff) == 2 * 12


def test_graph_capture_stamps_a_compile_span(gen, tmp_path):
    """With the goodput meter's flag armed, generate's decode-graph capture
    lands on the live tracer as a compile span of the capture's time."""
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.runtime.config import TelemetryConfig

    op_builder.arm_compile_spans()
    telemetry.configure(TelemetryConfig(enabled=True, output_dir=str(tmp_path)))
    try:
        eng = _graph_engine(gen)
        ids = torch.randint(0, 512, (2, 16), generator=gen, device="cuda")
        eng.generate(ids, max_new_tokens=8)
        loop, = eng._decode_loops.values()
        spans = [e for e in telemetry.get_tracer().events if e.get("cat") == "compile"
                 and e["args"]["phase"] == "cuda_graph_capture"]
        assert len(spans) == 1 and spans[0]["dur"] == pytest.approx(loop.capture_s * 1e6)
    finally:
        telemetry.deconfigure()


def test_hardware_report_names_the_card():
    """``ds_report``'s hardware rows on the card: the CUDA backend, the
    card's name as torch gives it, its memory, and nvidia-smi's name and
    power limit."""
    from deepspeed_tpu_torch import env_report

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    hw = dict(env_report.hardware_report())
    name = torch.cuda.get_device_name(0)
    assert hw["backend"] == "cuda" and hw["device name"] == name
    assert hw["device count"] == torch.cuda.device_count() >= 1
    assert "GiB" in hw["memory per device"]
    smi = hw["nvidia-smi name, power limit"]
    assert smi.split(",")[0].strip() in name or name in smi
    assert smi.rstrip().endswith("W")
