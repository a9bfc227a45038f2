#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deepspeed_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a Hopper GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``deepspeed_tpu_torch/csrc/``, holds
each kernel against its plain PyTorch version at the main paths' shapes and
at edge shapes, then drives the three ported paths at full width with random
weights, each with the launch counts set to 0 just before it and read just
after: serving llama3.2-1b (full depth) through ``init_inference`` →
``generate``, training gpt2-760m (full depth) through ``initialize`` →
``train_batch``, and training gpt2-1.3b (full depth, 2048 tokens) with the
ds_config ``sparse_attention`` block through the same entry points. It
checks that each run went through its kernels and that the kernel path
agrees with the plain path. ``generate`` runs its decode loop as replays of
a captured CUDA graph: the serving phase holds its greedy tokens against the
ungraphed loop's (``build_generate_parts``) and reports both loops' tokens/s.
It also serves two layers of llama3.2-1b in fp32 and fp16 and with sampling
(top-k) through the graphed loop, serves llama3.2-1b at full depth over an
8192-entry cache (B=4, the path the decode kernel's split over the cache is
for), and trains two layers of gpt2-2.7b (head dim 80), dense and
block-sparse, against the plain path. ``train gpt2-760m zero<stage>``
trains the dense training cell over a NCCL process group of one at ZeRO
stages 0-3 (every collective of the stage runs, a copy on the card at a
world of one), reports each stage's steps, collectives per step (the
``CommsLogger``, on one extra step) and stage-3 gathers, copies each
stage's whole state to the host as a save does and holds the card's peak
above the state to the largest unit, holds every stage's losses to stage
0's and three fp32 steps of two layers at stage 3 to stage 0's, and
destroys the group. Then it feeds, saves and resumes
gpt2-760m at full width and depth (``resume``): a token dataset written with
the port's indexed-dataset builder into a temporary directory, engine A
trained through ``initialize(training_data=...)``'s loader, saved with the
default async save and trained on, engines B and C built from other seeds
loading the tag and training on through their restored loaders; it holds
the state after each load to the saved state bit for bit, B's batches to
A's, and B's losses to A's as closely as to C's, and reports the tag's
bytes, the save's blocking and commit seconds, the write and read rates
and the data wait per step. ``curriculum`` trains the same model under the
legacy ``curriculum_learning`` block, T growing through ragged lengths to
1024 (the kernel checks hold the forward and both backward kernels against
their plain versions at each of those lengths), and reports the data wait
with the host truncation; ``resume ... 2-layer ladder`` truncates a file of the newest of two
tags (load falls back to the older), loads a corrupt tag by name (nothing
loads) and a model of another head count (``CheckpointLayoutError``). The
directory is removed afterwards. Each phase prints one JSON line; any
failed check raises, and the script exits non-zero without the final line.
It needs one card and imports nothing of JAX or of the JAX package.

The last lines are: the kernels' summary as ``{"kernels": [...]}``, the
card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Timing: each kernel time is CUDA-event device time per call, averaged over
``ITERS`` back-to-back calls queued behind a device sleep (so host launch
overhead does not show), with inputs rotated over copies totalling more than
the 50 MB L2 cache, as the model's per-layer calls find them cold.
``bound_ms`` is max(bytes moved / memory bandwidth, operations / peak rate
for the input type), from the accelerator's published peaks, counting each
input read once and each output written once. A training step is timed on
the host clock from the call to the loss on the host, step by step after
warm-up steps; the median is reported with every step's time.
"""

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
ITERS = 20
L2_BYTES = 50 * 2**20
MODEL = "llama3.2-1b"
BATCH, PROMPT, GEN = 32, 128, 128          # the serving cell
LONG_BATCH, LONG_PROMPT, LONG_GEN = 4, 7936, 256   # the long serving path: S = 8192
LONG_S = LONG_PROMPT + LONG_GEN
SMALL_LAYERS, SMALL_BATCH, SMALL_PROMPT, SMALL_GEN = 2, 4, 32, 16
PROFILE_STEPS = 4
TRAIN_MODEL = "gpt2-760m"
TRAIN_BATCH, TRAIN_SEQ = 8, 1024            # the training cell: micro batch 8, gas 1
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
# the JAX bench's training recipe (bench.py), on a world of one
TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": TRAIN_BATCH, "gradient_accumulation_steps": 1,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}},
                "bf16": {"enabled": True}, "zero_optimization": {"stage": 1},
                "gradient_clipping": 1.0, "steps_per_print": 0, "seed": SEED}
CHECK_FP32 = dict(layers=2, batch=2, gas=2, steps=3)   # the fp32 train check
# the ZeRO phase: the training cell's recipe at each stage, over a NCCL
# process group of one
ZERO_STAGES = (0, 1, 2, 3)
# the resume phase: a token dataset written with the port's indexed-dataset
# builder, steps before and after the save, and the disk the tag needs
RESUME_SAMPLES, RESUME_STEPS = 64, 3
STATE_BYTES_PER_PARAM = 14          # bf16 params, fp32 masters, two fp32 moments
DISK_MARGIN = 2.5                   # free space wanted per byte of the tag
# the curriculum phase: the legacy block, T from 64 towards 1024 in 8 steps
CURRICULUM = {"enabled": True, "curriculum_type": "seqlen", "min_difficulty": 64,
              "max_difficulty": TRAIN_SEQ, "schedule_type": "fixed_linear",
              "schedule_config": {"total_curriculum_step": 8, "difficulty_step": 8}}
CURRICULUM_STEPS = 9
SPARSE_MODEL = "gpt2-1.3b"
SPARSE_BATCH, SPARSE_SEQ = 4, 2048          # the sparse training cell: micro batch 4, gas 1
# the reference's documented "fixed" layout (DeepSpeed docs, config-json
# "Sparse Attention"), unidirectional as a GPT model uses it
SPARSE_BLOCK = {"mode": "fixed", "block": 16, "different_layout_per_head": True,
                "num_local_blocks": 4, "num_global_blocks": 1, "attention": "unidirectional",
                "horizontal_global_attention": False, "num_different_global_patterns": 4}

# the offload phases: gpt2-2.7b and gpt2-6.7b at 4 x 2048 with remat (the
# presets' own), bf16 with fp32 masters, ZeRO stage 1 without a process group
OFFLOAD_MODEL, CAPACITY_MODEL = "gpt2-2.7b", "gpt2-6.7b"
OFFLOAD_BATCH, OFFLOAD_SEQ = 4, 2048
OFFLOAD_CONFIG = {**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": OFFLOAD_BATCH}
OFFLOAD_KNOBS = ("DS_TPU_OFFLOAD_MASTER", "DS_TPU_FORCE_STREAMED_OFFLOAD",
                 "DS_TPU_OFFLOAD_CHUNK_BYTES", "DS_TPU_OFFLOAD_OVERLAP")
HOST_BYTES_PER_PARAM = 12           # fp32 master and two fp32 moments in host memory
HOST_MARGIN = 6e9                   # host memory left for the run beside that state
MIN_CAPACITY_LAYERS = 21            # 18 B/param on the card still exceeds 80 GB here
# the NVMe phases: gpt2-2.7b's width at 4 layers; the swap through 8 I/O threads
NVME_LAYERS, NVME_WARMUP, NVME_STEPS = 4, 1, 2
NVME_AIO = {"block_size": 1 << 20, "thread_count": 8}
AIO_COUNTS = ("direct_chunks", "buffered_chunks", "direct_bytes", "buffered_bytes")
NVME_FP32 = dict(layers=2, batch=2, seq=1024, steps=3)
NVME_LOSS_RTOL = 1e-2               # bf16: the Infinity engine keeps the top-level weights
                                    # in fp32 where the engine rounds them to bf16

# tolerances, with their reasons
# kernel vs plain fp32 on the same inputs: a bf16 or fp16 output carries its
# own rounding (2^-9 or 2^-11 relative, |o| < ~5 for unit-normal v); fp32
# outputs and the fp32 LSE differ only in summation order
TOL = {torch.bfloat16: {"o": 2e-2, "lse": 1e-3}, torch.float16: {"o": 2e-2, "lse": 1e-3},
       torch.float32: {"o": 1e-4, "lse": 1e-4}}
# decode outputs are also held to this share of the reference's largest
# value: softmax over N keys of unit-normal v gives outputs of size about
# sqrt(e / N) (0.018 at N = 8192), as large as the absolute limit above
DECODE_RTOL = 2e-2
# llama3.2-1b bf16 logits, kernel path vs plain path on the same weights: the
# plain path rounds scores and probabilities to bf16, the kernels keep them in
# fp32, and 16 layers carry the difference to the logits
LOGIT_RTOL = 5e-2
# backward kernels vs plain fp32 on the same inputs, as a share of the largest
# reference gradient floored at 1 (the inputs are unit normal): a bf16 or
# fp16 output carries its own rounding (2^-9 or 2^-11 of the largest value,
# 5x margin); fp32 outputs differ only in summation order. The floor keeps a
# gradient that is zero in exact arithmetic (dQ with a single key:
# dS = P (dP - delta) = 0) from being held to its own fp32 cancellation noise.
GRAD_RTOL = {torch.bfloat16: 1e-2, torch.float16: 2.5e-3, torch.float32: 1e-4}
# gpt2-760m bf16 step, kernel path vs plain path on the same weights and
# batch: the plain path rounds scores and probabilities to bf16 and 24 layers
# carry that into the loss and gradients; the kernel path keeps them in fp32.
# Loss: relative difference. Gradients: per tensor, the L2 norm of the
# difference over the L2 norm of the plain path's gradient.
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_RTOL = 1e-1
# the fp32 2-layer run after three AdamW steps: losses relative, and the
# params' difference in L2 over all tensors together against the params' L2.
# Not per tensor: the key bias adds the same amount to every score of a row,
# so its gradient is zero in exact arithmetic and each path's is rounding
# noise, which Adam turns into steps; a zero-initialized tensor compared to
# its own norm measures that noise (3.5e-3 on blocks.0.qkv_b on an H100), not
# the kernels.
FP32_RTOL = 1e-4
# the fp32 2-layer NVMe runs against the engine in memory: the same model
# path, AdamW on the host (fused multiply-adds of the CPU) against the card's
FP32_NVME_RTOL = 1e-5


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, arg_sets):
    """Device ms per call of fn(*args), args rotated over ``arg_sets``."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)   # holds the device while the host queues the calls
    start.record()
    for i in range(ITERS):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def n_copies(set_bytes: int) -> int:
    return max(2, min(16, math.ceil(2 * L2_BYTES / max(1, set_bytes))))


def bound_ms(accel, nbytes: int, ops: float, dtype) -> tuple:
    t_bytes = nbytes / accel.memory_bandwidth()
    t_ops = ops / accel.peak_flops(dtype)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


_PTX_TYPES = {"13__nv_bfloat16": "bf16", "6__half": "fp16"}   # mangled template types


def _instance_name(mangled: str):
    """``kernel<type,D,...>`` from a mangled kernel entry, else None."""
    m = re.search(r"\d((?:flash|sparse|decode)_[a-z0-9_]*?kernel)I(.*)", mangled)
    if not m:
        return None
    args = re.findall(r"(13__nv_bfloat16|6__half|Li(\d+)E)", m.group(2).split("EEv")[0])
    return f"{m.group(1)}<{','.join(_PTX_TYPES.get(a, n) for a, n in args)}>"


def ptxas_summary(log: str) -> dict:
    """Most registers and total spill-store bytes over the kernel's
    template instances, from nvcc's -Xptxas -v report; for each
    tensor-core instance (``*_mma_kernel<type, D>``) its registers and
    spill-store bytes, and every instance that spills, by name."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
    per, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = _instance_name(entry.group(1))
            if name:
                per[name] = {"registers": 0, "spill_store_bytes": 0}
        elif name and (sp := re.search(r"(\d+) bytes spill stores", line)):
            per[name]["spill_store_bytes"] = int(sp.group(1))
        elif name and (rg := re.search(r"Used (\d+) registers", line)):
            per[name]["registers"] = int(rg.group(1))
    out = {"instances": len(regs), "max_registers": max(regs, default=0),
           "spill_store_bytes": sum(spills),
           "spilling": {n: v["spill_store_bytes"] for n, v in per.items()
                        if v["spill_store_bytes"]}}
    mma = {n: v for n, v in per.items() if "_mma_kernel<" in n}
    if mma:
        out["mma_instances"] = mma
    return out


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# ------------------------------------------------------------------ kernels
def _pairs(t_q: int, t_k: int, causal: bool) -> int:
    """Visible (query, key) pairs of one head, top-left causal."""
    return sum(min(i + 1, t_k) for i in range(t_q)) if causal else t_q * t_k


def check_flash(fa, accel, gen, name, B, T, H, D, dtype, causal, Tk=None):
    """The forward kernel against its plain version at one shape (Tq = T,
    Tk = Tk or T), twice on the same inputs (the bits must repeat), then its
    time beside the bound, the plain version and SDPA."""
    import torch.nn.functional as F

    Tk = Tk or T
    scale = 1.0 / math.sqrt(D)
    item = torch.tensor([], dtype=dtype).element_size()
    per_set = 2 * B * H * (T + Tk) * D * item
    sets = []
    for _ in range(n_copies(per_set)):
        q = torch.randn(B * H, T, D, generator=gen, device="cuda")
        k, v = (torch.randn(B * H, Tk, D, generator=gen, device="cuda") for _ in range(2))
        sets.append(((q * scale).to(dtype), k.to(dtype), v.to(dtype)))
    q, k, v = sets[0]
    o, lse = fa.flash_forward(q, k, v, causal)
    o2, lse2 = fa.flash_forward(q, k, v, causal)
    o_ref, lse_ref = fa.mha_reference_lse(q.float(), k.float(), v.float(), causal)
    torch.cuda.synchronize()
    err_o, err_lse = max_err(o, o_ref), max_err(lse, lse_ref)
    repeat = torch.equal(o, o2) and torch.equal(lse, lse2)
    tol = TOL[dtype]
    if not (err_o <= tol["o"] and err_lse <= tol["lse"]) or not torch.isfinite(o).all() \
            or not repeat:
        raise AssertionError(f"flash_attention_fwd {name}: o err {err_o}, lse err {err_lse} "
                             f"over {tol}; bitwise repeat {repeat}")
    nbytes = per_set + B * H * T * 4
    b_ms, b_by = bound_ms(accel, nbytes, 4.0 * D * _pairs(T, Tk, causal) * B * H, dtype)
    sdpa = lambda q, k, v: F.scaled_dot_product_attention(
        q.view(B, H, T, D), k.view(B, H, Tk, D), v.view(B, H, Tk, D),
        is_causal=causal, scale=1.0)
    row = {"name": name, "shape": [B, T, H, D], "t_k": Tk, "dtype": str(dtype),
           "causal": causal, "max_abs_err": err_o, "lse_max_abs_err": err_lse, "tol": tol,
           "bitwise_repeat": repeat,
           "ms": time_ms(lambda q, k, v: fa.flash_forward(q, k, v, causal), sets),
           "plain_ms": time_ms(lambda q, k, v: fa.mha_reference_lse(q, k, v, causal), sets),
           "library_ms": time_ms(sdpa, sets), "bound_ms": b_ms, "bound_by": b_by}
    row["tflops"] = 4.0 * D * _pairs(T, Tk, causal) * B * H / row["ms"] / 1e9
    row["bound_share"] = b_ms / row["ms"]
    emit("kernel flash_attention_fwd", **row)
    return row


def check_decode(da, accel, gen, name, B, S, H, KV, Dh, dtype, pos, garbage=False):
    """The split decode kernel against its plain version (and the split's
    plain version against it) at one shape, with its chunk and grid, then its
    time beside the bound, the plain version and SDPA with GQA. With
    ``garbage``, entries past pos hold +-1e9 and NaN, which must not be
    read."""
    import torch.nn.functional as F

    n_valid = min(pos + 1, S)
    chunk = da.decode_chunk(B, KV, S, torch.cuda.get_device_properties(0).multi_processor_count)
    item = torch.tensor([], dtype=dtype).element_size()
    per_set = (2 * B * S * KV * Dh + 2 * B * H * Dh) * item
    sets = []
    for _ in range(n_copies(per_set)):
        q = torch.randn(B, H, Dh, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(B, S, KV, Dh, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        sets.append((q, k, v, torch.tensor(pos, dtype=torch.int32, device="cuda")))
    q, k, v, pos_t = sets[0]
    ref = da.decode_reference(q.float(), k.float(), v.float(), pos)
    split_err = max_err(da.decode_split_reference(q.float(), k.float(), v.float(), pos_t, chunk),
                        ref)
    if garbage:   # entries past pos must not change the output
        k, v = k.clone(), v.clone()
        k[:, pos + 1:] = 1e9
        k[:, pos + 1::2] = -1e9
        v[:, pos + 1:] = float("nan")
    out = da.decode_attention(q, k, v, pos_t)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    tol = min(TOL[dtype]["o"], DECODE_RTOL * ref.abs().max().item())
    if not err <= tol or not torch.isfinite(out).all() \
            or not split_err <= TOL[torch.float32]["o"]:
        raise AssertionError(f"decode_attention {name}: err {err} over {tol}; "
                             f"the split's plain version {split_err} from the plain one")
    nbytes = (2 * B * n_valid * KV * Dh + 2 * B * H * Dh) * item
    ops = 4.0 * B * H * n_valid * Dh
    b_ms, b_by = bound_ms(accel, nbytes, ops, dtype)
    sdpa = lambda q, k, v, p: F.scaled_dot_product_attention(
        q.view(B, H, 1, Dh), k[:, :n_valid].transpose(1, 2), v[:, :n_valid].transpose(1, 2),
        scale=1.0 / math.sqrt(Dh), enable_gqa=True)
    n_chunks = -(-S // chunk)
    groups = -(-(H // KV) // (16 if dtype != torch.float32 else 8))
    row = {"name": name, "shape": [B, S, H, KV, Dh], "pos": pos, "dtype": str(dtype),
           "chunk": chunk, "ctas": B * KV * groups * n_chunks,
           "active_ctas": B * KV * groups * -(-n_valid // chunk), "merge": n_chunks > 1,
           "max_abs_err": err, "split_plain_max_abs_err": split_err, "tol": tol,
           "ms": time_ms(da.decode_attention, sets),
           "plain_ms": time_ms(da.decode_reference, sets),
           "library_ms": time_ms(sdpa, sets), "bound_ms": b_ms, "bound_by": b_by}
    row["tflops"] = ops / row["ms"] / 1e9
    row["gbytes_per_s"] = nbytes / row["ms"] / 1e6
    row["bound_share"] = b_ms / row["ms"]
    emit("kernel decode_attention", **row)
    return row


def check_flash_bwd(fa, accel, gen, name, BH, T, D, dtype, causal, Tk=None):
    """Both backward kernels against their plain versions at one shape (Tq =
    T, Tk = Tk or T), each twice on the same inputs (the bits must repeat;
    under causal, keys no query sees must get dk = dv = 0 exactly), then
    their times beside the bound, the plain versions and
    scaled_dot_product_attention's backward and forward+backward."""
    import torch.nn.functional as F

    Tk = Tk or T
    item = torch.tensor([], dtype=dtype).element_size()
    per_set = 2 * BH * (T + Tk) * D * item
    sets = []
    for _ in range(n_copies(per_set)):
        q, do = (torch.randn(BH, T, D, generator=gen, device="cuda") for _ in range(2))
        k, v = (torch.randn(BH, Tk, D, generator=gen, device="cuda") for _ in range(2))
        q, k, v, do = (q * D ** -0.5).to(dtype), k.to(dtype), v.to(dtype), do.to(dtype)
        o, lse = fa.flash_forward(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1)
        sets.append((q, k, v, do, lse, delta))
    q, k, v, do, lse, delta = sets[0]
    dq = fa.flash_backward_dq(q, k, v, do, lse, delta, causal)
    dq2 = fa.flash_backward_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, lse, delta, causal)
    dk2, dv2 = fa.flash_backward_dkv(q, k, v, do, lse, delta, causal)
    ref = fa.mha_backward_reference(q.float(), k.float(), v.float(), do.float(), lse, delta,
                                    causal)
    torch.cuda.synchronize()
    tol = GRAD_RTOL[dtype]
    errs, scales = {}, {}
    for n, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        errs[n], scales[n] = max_err(g, r), r.abs().max().item()
        if not torch.isfinite(g).all() or errs[n] > tol * max(1.0, scales[n]):
            raise AssertionError(f"flash_attention_bwd {name}: {n} err {errs[n]} over "
                                 f"{tol} x {scales[n]}")
    dq_repeat = torch.equal(dq, dq2)
    repeat = torch.equal(dk, dk2) and torch.equal(dv, dv2)
    unseen = int(torch.count_nonzero(dk[:, T:]).item() + torch.count_nonzero(dv[:, T:]).item()) \
        if causal and Tk > T else 0
    if not (repeat and dq_repeat) or unseen:
        raise AssertionError(f"flash_attention_bwd {name}: bitwise repeat dq {dq_repeat}, "
                             f"dk/dv {repeat}; {unseen} nonzero dk/dv entries of keys no "
                             f"query sees")
    pairs = _pairs(T, Tk, causal) * BH
    rows_q, rows_k = BH * T, BH * Tk
    dq_bound = bound_ms(accel, (3 * rows_q + 2 * rows_k) * D * item + 8 * rows_q,
                        6.0 * D * pairs, dtype)
    dkv_bound = bound_ms(accel, (2 * rows_q + 4 * rows_k) * D * item + 8 * rows_q,
                         8.0 * D * pairs, dtype)

    def sdpa_sets():
        out = []
        for q, k, v, do, _, _ in sets:
            q, k, v = (x.view(1, *x.shape).detach().requires_grad_() for x in (q, k, v))
            o = F.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=1.0)
            out.append((q, k, v, o, do.view(1, *do.shape)))
        return out

    lib = sdpa_sets()
    lib_bwd = lambda q, k, v, o, do: torch.autograd.grad(o, (q, k, v), do, retain_graph=True)
    lib_fwd_bwd = lambda q, k, v, o, do: torch.autograd.grad(
        F.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=1.0), (q, k, v), do)
    row = {"name": name, "shape": [BH, T, D], "t_k": Tk, "dtype": str(dtype), "causal": causal,
           "max_abs_err": max(errs.values()), "errs": errs, "ref_max_abs": scales,
           "rtol": tol, "dq_bitwise_repeat": dq_repeat, "dkv_bitwise_repeat": repeat,
           "unseen_key_nonzero": unseen,
           "dq_ms": time_ms(lambda *a: fa.flash_backward_dq(*a, causal), sets),
           "dkv_ms": time_ms(lambda *a: fa.flash_backward_dkv(*a, causal), sets),
           "dq_plain_ms": time_ms(lambda *a: fa.mha_backward_dq_reference(*a, causal), sets),
           "dkv_plain_ms": time_ms(lambda *a: fa.mha_backward_dkv_reference(*a, causal), sets),
           "dq_bound_ms": dq_bound[0], "dq_bound_by": dq_bound[1],
           "dkv_bound_ms": dkv_bound[0], "dkv_bound_by": dkv_bound[1],
           "library_bwd_ms": time_ms(lib_bwd, lib), "library_fwd_bwd_ms": time_ms(lib_fwd_bwd, lib)}
    row["dq_tflops"] = 6.0 * D * pairs / row["dq_ms"] / 1e9
    row["dq_bound_share"] = dq_bound[0] / row["dq_ms"]
    row["dkv_tflops"] = 8.0 * D * pairs / row["dkv_ms"] / 1e9
    row["dkv_bound_share"] = dkv_bound[0] / row["dkv_ms"]
    del lib
    emit("kernel flash_attention_bwd", **row)
    return row


def check_sparse(fa, accel, gen, name, BH, T, D, dtype, layout, causal):
    """The three block-sparse kernels against their plain versions at one
    shape and layout, each twice on the same inputs (the bits must repeat),
    then their times beside the bound, the plain versions and
    scaled_dot_product_attention under the layout's token mask, with the
    schedules' useful shares (the forward walks the dq schedule). An
    unattended key block must get dk = dv = 0 exactly; a dense layout must
    give the dense flash kernel's output."""
    import torch.nn.functional as F

    pairs = fa.sparse_pairs(layout, causal, T, "cuda")
    item = torch.tensor([], dtype=dtype).element_size()
    per_set = 4 * BH * T * D * item
    sets = []
    for _ in range(n_copies(per_set)):
        q, k, v, do = (torch.randn(BH, T, D, generator=gen, device="cuda") for _ in range(4))
        q, k, v, do = (q * D ** -0.5).to(dtype), k.to(dtype), v.to(dtype), do.to(dtype)
        o, lse = fa.sparse_forward(q, k, v, layout, causal)
        delta = (do.float() * o.float()).sum(-1)
        sets.append((q, k, v, do, lse, delta))
    q, k, v, do, lse, delta = sets[0]
    o, lse = fa.sparse_forward(q, k, v, layout, causal)
    o2, lse2 = fa.sparse_forward(q, k, v, layout, causal)
    dq = fa.sparse_backward_dq(q, k, v, do, lse, delta, layout, causal)
    dk, dv = fa.sparse_backward_dkv(q, k, v, do, lse, delta, layout, causal)
    dq2 = fa.sparse_backward_dq(q, k, v, do, lse, delta, layout, causal)
    dk2, dv2 = fa.sparse_backward_dkv(q, k, v, do, lse, delta, layout, causal)
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    o_ref, lse_ref = fa.sparse_reference_lse(q32, k32, v32, layout, causal)
    refs = (fa.sparse_backward_dq_reference(q32, k32, v32, do32, lse, delta, layout, causal),
            *fa.sparse_backward_dkv_reference(q32, k32, v32, do32, lse, delta, layout, causal))
    torch.cuda.synchronize()
    tol, gtol = TOL[dtype], GRAD_RTOL[dtype]
    err_o, err_lse = max_err(o, o_ref), max_err(lse, lse_ref)
    fwd_repeat = torch.equal(o, o2) and torch.equal(lse, lse2)
    if not (err_o <= tol["o"] and err_lse <= tol["lse"]) or not torch.isfinite(o).all() \
            or not fwd_repeat:
        raise AssertionError(f"sparse_attention_fwd {name}: o err {err_o}, lse err {err_lse} "
                             f"over {tol}; bitwise repeat {fwd_repeat}")
    errs, scales = {}, {}
    for n, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        errs[n], scales[n] = max_err(g, r), r.abs().max().item()
        if not torch.isfinite(g).all() or errs[n] > gtol * max(1.0, scales[n]):
            raise AssertionError(f"sparse_attention_bwd {name}: {n} err {errs[n]} over "
                                 f"{gtol} x {scales[n]}")
    repeat = torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    if not repeat:
        raise AssertionError(f"sparse_attention_bwd {name}: repeated calls differ")
    row = {"name": name, "shape": [BH, T, D], "dtype": str(dtype), "causal": causal,
           "layout_blocks": pairs.n, "block": pairs.block,
           "pairs": int(pairs.row_cols_np.size), "visible_per_head": pairs.visible,
           "max_keys_per_row": int(np.diff(pairs.row_ptr_np).max()),
           "max_queries_per_col": int(np.diff(pairs.col_ptr_np).max()),
           # the backward CTA schedules: CTAs, the share of warp-chunk slots
           # that do work, and the most 16-row chunks one CTA streams
           **{f"{side}_schedule": {"ctas": s.n_cta, "useful_share": s.useful_share,
                                   "longest_chunks": s.longest}
              for side, s in (("dq", pairs.dq), ("dkv", pairs.dkv))},
           "max_abs_err": err_o, "lse_max_abs_err": err_lse, "tol": tol, "grad_errs": errs,
           "grad_ref_max_abs": scales, "grad_rtol": gtol, "fwd_bitwise_repeat": fwd_repeat,
           "bwd_bitwise_repeat": repeat}
    empty = np.flatnonzero(np.diff(pairs.col_ptr_np) == 0)
    if empty.size:      # keys no query attends: exactly zero, never garbage
        keys = torch.from_numpy(
            (empty[:, None] * pairs.block + np.arange(pairs.block)).ravel()).cuda()
        nonzero = int((dk[:, keys] != 0).sum().item() + (dv[:, keys] != 0).sum().item())
        row["unattended_key_blocks"] = int(empty.size)
        row["unattended_nonzero_grads"] = nonzero
        if nonzero:
            raise AssertionError(f"sparse_attention_bwd_dkv {name}: {nonzero} nonzero dk/dv "
                                 f"entries in {empty.size} unattended key blocks")
    dense = np.ones_like(pairs.layout)
    if np.array_equal(pairs.layout, np.tril(dense) if causal else dense):
        o_dense, _ = fa.flash_forward(q, k, v, causal)
        row["vs_dense_flash_max_abs_err"] = max_err(o, o_dense)
        if row["vs_dense_flash_max_abs_err"] > tol["o"]:
            raise AssertionError(f"sparse {name}: dense layout differs from the flash kernel "
                                 f"by {row['vs_dense_flash_max_abs_err']}")

    visible = pairs.visible * BH
    rows = BH * T
    ops = {"fwd": 4.0 * D * visible, "dq": 6.0 * D * visible, "dkv": 8.0 * D * visible}
    for entry, nbytes in (("fwd", per_set + 4 * rows), ("dq", 5 * rows * D * item + 8 * rows),
                          ("dkv", 6 * rows * D * item + 8 * rows)):
        row[f"{entry}_bound_ms"], row[f"{entry}_bound_by"] = bound_ms(accel, nbytes, ops[entry],
                                                                      dtype)
    row.update(
        fwd_ms=time_ms(lambda q, k, v, *_: fa.sparse_forward(q, k, v, layout, causal), sets),
        dq_ms=time_ms(lambda *a: fa.sparse_backward_dq(*a, layout, causal), sets),
        dkv_ms=time_ms(lambda *a: fa.sparse_backward_dkv(*a, layout, causal), sets),
        fwd_plain_ms=time_ms(lambda q, k, v, *_: fa.sparse_reference_lse(q, k, v, layout, causal),
                             sets),
        dq_plain_ms=time_ms(lambda *a: fa.sparse_backward_dq_reference(*a, layout, causal), sets),
        dkv_plain_ms=time_ms(lambda *a: fa.sparse_backward_dkv_reference(*a, layout, causal),
                             sets))
    for entry in ops:   # visible-pair work only
        row[f"{entry}_tflops"] = ops[entry] / row[f"{entry}_ms"] / 1e9
        row[f"{entry}_bound_share"] = row[f"{entry}_bound_ms"] / row[f"{entry}_ms"]

    mask = pairs.mask
    sdpa = lambda q, k, v: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)
    lib = []
    for q, k, v, do, _, _ in sets:
        q, k, v = (x.view(1, BH, T, D).detach().requires_grad_() for x in (q, k, v))
        lib.append((q, k, v, sdpa(q, k, v), do.view(1, BH, T, D)))
    row.update(
        fwd_library_ms=time_ms(lambda q, k, v, *_: sdpa(q, k, v), lib),
        library_bwd_ms=time_ms(lambda q, k, v, o, do: torch.autograd.grad(
            o, (q, k, v), do, retain_graph=True), lib),
        library_fwd_bwd_ms=time_ms(lambda q, k, v, o, do: torch.autograd.grad(
            sdpa(q, k, v), (q, k, v), do), lib))
    del lib, sets
    emit("kernel sparse_attention", **row)
    return row


def sparse_cases(fa, SparsityConfigs):
    """(name, BH, T, D, dtype, layout, causal) of every kernel sparse check;
    the first is the training cell's shape."""
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention

    bf, BH, T = torch.bfloat16, SPARSE_BATCH * 16, SPARSE_SEQ
    fixed = lambda block: sparse_self_attention({**SPARSE_BLOCK, "block": block},
                                                16).get_layout(T)
    cell = fixed(16)
    n = T // 16
    unattended = np.zeros((n, n), dtype=bool)
    unattended[:, 0] = True
    unattended[np.arange(0, n, 2), np.arange(0, n, 2)] = True   # odd key blocks: no query
    return [
        ("train_fixed16", BH, T, 128, bf, cell, True),
        ("fixed32", BH, T, 128, bf, fixed(32), True),
        ("fixed64", BH, T, 128, bf, fixed(64), True),
        ("fixed128", BH, T, 128, bf, fixed(128), True),
        ("d64", BH, T, 64, bf, cell, True),
        ("d96", BH, T, 96, bf, cell, True),
        ("d16", BH, T, 16, bf, cell, True),
        ("d32", BH, T, 32, bf, cell, True),
        ("d80", BH, T, 80, bf, cell, True),
        ("fp16_d80", BH, T, 80, torch.float16, fixed(32), True),
        ("fp32_d80", BH, T, 80, torch.float32, cell, True),
        ("fp32_d16", BH, T, 16, torch.float32, fixed(64), True),
        ("fp32", BH, T, 128, torch.float32, cell, True),
        ("fp16", BH, T, 128, torch.float16, cell, True),
        ("bigbird_noncausal", BH, T, 128, bf,
         SparsityConfigs.BigBirdSparsityConfig(16, block=16).make_layout(T), False),
        ("bslongformer", BH, T, 128, bf,
         SparsityConfigs.BSLongformerSparsityConfig(16, block=16).make_layout(T), True),
        ("unattended_keys", BH, T, 128, bf, unattended, True),
        ("dense_layout", BH, T, 128, bf,
         SparsityConfigs.DenseSparsityConfig(16, block=64).make_layout(T), True),
    ]


# -------------------------------------------------------------------- slice
def _generate_key(batch, prompt, gen, do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                  eos=None):
    """The engine's key for its decode loop of one generate call."""
    return (batch, prompt, gen, do_sample, temperature, top_k, top_p, eos)


def _eager_generate(engine, ids, gen, seed=0, **sample):
    """The ungraphed decode loop (``build_generate_parts``) on the engine's
    model: (tokens, seconds of prefill + decode)."""
    from deepspeed_tpu_torch.inference.engine import build_generate_parts

    prefill, decode = build_generate_parts(engine.module, gen, sample.get("do_sample", False),
                                           sample.get("temperature", 1.0),
                                           sample.get("top_k", 0), sample.get("top_p", 1.0),
                                           None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, cache = prefill(ids)
        out = decode(ids, logits, cache, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _graphed_generate(engine, ids, gen, fa, da, n_layer):
    """Two graphed ``generate`` calls with one key, each with the launch
    counts set to 0 just before it and read just after: the first captures
    the decode step after one warm-up step, the second only replays it (the
    same graph object). Each launches the flash kernel once per layer and
    the decode kernel once per layer and step (the warm-up's step included),
    and both give the same tokens. → (tokens, first seconds, second seconds,
    the decode loop, the first call's launches, the second's)."""
    times, outs, counted = [], [], []
    loop, graph = None, None
    for call in range(2):
        expect = {"flash_attention_fwd": n_layer,
                  "decode_attention": n_layer * (gen + (call == 0))}
        fa.KERNEL.reset_launches()
        da.KERNEL.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(engine.generate(ids, max_new_tokens=gen))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = {"flash_attention_fwd": fa.KERNEL.launches,
                    "decode_attention": da.KERNEL.launches}
        if launches != expect:
            raise AssertionError(f"generate call {call + 1}: launch counts {launches}, "
                                 f"expected {expect}")
        counted.append(launches)
        loop = engine._decode_loops[_generate_key(*ids.shape, gen)]
        if call == 0:
            graph = loop.graph
    if graph is None or loop.graph is not graph:
        raise AssertionError("the second generate with the same key captured again")
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError("two graphed generate calls with one key gave other tokens")
    return outs[1], times[0], times[1], loop, counted[0], counted[1]


def _prefill_ms(model, ids, capacity):
    """Median of three timed prefills, and the last one's (logits, cache)."""
    times = []
    for _ in range(3):
        cache = model.init_cache(ids.shape[0], capacity)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(ids, cache)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[1], logits, cache


def _replay_ms(loop, logits, cache, steps):
    """Device ms per replay of the captured decode step, by CUDA events over
    ``steps`` back-to-back replays from a freshly loaded state."""
    loop.load(logits, cache, 0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(steps):
        loop.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def serve_slice(init_inference, LlamaModel, cfg, accel, fa, da):
    """llama3.2-1b, bf16, full width and depth: the counted main-path run,
    through the graphed decode loop, beside the ungraphed loop."""
    c = dataclasses.replace(cfg, use_flash_decode=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = LlamaModel(c).init_params(gen)
    engine = init_inference(model, {"dtype": "bfloat16", "max_out_tokens": PROMPT + GEN})
    ids = torch.randint(0, c.vocab_size, (BATCH, PROMPT), generator=gen, device="cuda")

    engine.generate(ids[:2, :8], max_new_tokens=2)   # warm-up (library handles)
    torch.cuda.synchronize()
    accel.reset_peak_memory_stats()
    out, first_s, gen_s, loop, first_launches, launches = _graphed_generate(engine, ids, GEN,
                                                                           fa, da, c.n_layer)
    peak_gb = accel.max_memory_allocated() / 1e9
    if tuple(out.shape) != (BATCH, PROMPT + GEN) or not torch.equal(out[:, :PROMPT], ids) \
            or out.min().item() < 0 or out.max().item() >= c.vocab_size:
        raise AssertionError(f"generate output malformed: {tuple(out.shape)}")
    eager, eager_s = _eager_generate(engine, ids, GEN)
    if not torch.equal(eager, out):
        raise AssertionError(f"graphed and eager greedy tokens differ in "
                             f"{int((eager != out).sum().item())} places")

    # the same weights through the plain versions, selected by the model's own
    # flags (use_flash_attention / use_flash_decode off), not as a fallback
    plain = LlamaModel(dataclasses.replace(c, use_flash_attention=False, use_flash_decode=False))
    plain.load_state_dict(model.state_dict(), assign=True)
    with torch.inference_mode():
        prefill_med, logits, cache = _prefill_ms(model, ids, PROMPT + GEN)
        replay_ms = _replay_ms(loop, logits, cache, GEN)
        ref, ref_cache = plain.prefill(ids, plain.init_cache(BATCH, PROMPT + GEN))
        tok = torch.argmax(logits, dim=-1)
        step_k, _ = model.decode_step(tok, cache)
        step_p, _ = plain.decode_step(tok, ref_cache)
    scale = ref.abs().max().item()
    err_prefill, err_step = max_err(logits, ref), max_err(step_k, step_p)
    if not (torch.isfinite(logits).all() and torch.isfinite(step_k).all()) \
            or err_prefill > LOGIT_RTOL * scale or err_step > LOGIT_RTOL * step_p.abs().max().item():
        raise AssertionError(f"kernel path vs plain path: prefill logits err {err_prefill}, "
                             f"decode logits err {err_step}, |ref| max {scale}")
    decode_s = gen_s - prefill_med / 1e3
    eager_decode_s = eager_s - prefill_med / 1e3
    emit(f"slice {MODEL}", batch=BATCH, prompt=PROMPT, gen=GEN, dtype="bfloat16",
         launches=launches, first_call_launches=first_launches, generate_s=gen_s,
         first_generate_s=first_s,
         capture_s=loop.capture_s, prefill_ms=prefill_med,
         decode_tok_s=BATCH * GEN / decode_s, decode_ms_per_step=decode_s * 1e3 / GEN,
         replay_device_ms_per_step=replay_ms,
         eager_generate_s=eager_s, eager_decode_tok_s=BATCH * GEN / eager_decode_s,
         eager_decode_ms_per_step=eager_decode_s * 1e3 / GEN, eager_tokens_identical=True,
         peak_mem_gb=peak_gb, prefill_logits_max_abs_err=err_prefill,
         decode_logits_max_abs_err=err_step, ref_logits_max_abs=scale,
         logit_rtol=LOGIT_RTOL,
         top1_agree=(logits.argmax(-1) == ref.argmax(-1)).float().mean().item())
    with torch.inference_mode():
        profile_slice(model, engine, loop, ids, step_k, cache, c.n_layer)
    del engine, model, plain, cache, ref_cache, loop
    torch.cuda.empty_cache()
    return launches


def _long_vs_plain(LlamaModel, c, model, gen):
    """The kernel path against the plain path (use_flash_attention /
    use_flash_decode off, the same weights) at the long path's batch and
    longest positions: prefill over LONG_S - 1 tokens, then one decode step
    at pos LONG_S - 1, the cache's last entry. The plain path's (H, T, T)
    scores take ~26 GB per batch row, so its prefill runs row by row into
    one cache. → (prefill err, its |ref| max, decode err, its |ref| max,
    all finite)."""
    plain = LlamaModel(dataclasses.replace(c, use_flash_attention=False, use_flash_decode=False))
    plain.load_state_dict(model.state_dict(), assign=True)
    ids = torch.randint(0, c.vocab_size, (LONG_BATCH, LONG_S - 1), generator=gen,
                        device="cuda")
    with torch.inference_mode():
        logits, cache = model.prefill(ids, model.init_cache(LONG_BATCH, LONG_S))
        ref_cache = plain.init_cache(LONG_BATCH, LONG_S)
        ref = torch.cat([plain.prefill(ids[b:b + 1], {"k": ref_cache["k"][:, b:b + 1],
                                                      "v": ref_cache["v"][:, b:b + 1],
                                                      "pos": ref_cache["pos"]})[0]
                         for b in range(LONG_BATCH)])
        ref_cache["pos"] = cache["pos"].clone()
        tok = torch.argmax(ref, dim=-1)
        step_k, _ = model.decode_step(tok, cache)
        step_p, _ = plain.decode_step(tok, ref_cache)
    finite = bool(torch.isfinite(logits).all().item() and torch.isfinite(step_k).all().item())
    return (max_err(logits, ref), ref.abs().max().item(), max_err(step_k, step_p),
            step_p.abs().max().item(), finite)


def serve_long(init_inference, LlamaModel, cfg, fa, da):
    """llama3.2-1b, bf16, full width and depth, B=4 over an 8192-entry cache
    (prompt 7936, 256 new tokens), graphed and greedy: the path on which the
    split of the decode kernel over the cache matters end to end. Its tokens
    must equal the ungraphed loop's, and its logits at prefill and at the
    cache's last position the plain path's."""
    c = dataclasses.replace(cfg, use_flash_decode=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    model = LlamaModel(c).init_params(gen)
    engine = init_inference(model, {"dtype": "bfloat16", "max_out_tokens": LONG_S})
    ids = torch.randint(0, c.vocab_size, (LONG_BATCH, LONG_PROMPT), generator=gen,
                        device="cuda")
    out, first_s, gen_s, loop, first_launches, launches = _graphed_generate(
        engine, ids, LONG_GEN, fa, da, c.n_layer)
    eager, eager_s = _eager_generate(engine, ids, LONG_GEN)
    same = torch.equal(eager, out)
    with torch.inference_mode():
        prefill_med, logits, cache = _prefill_ms(model, ids, LONG_S)
        replay_ms = _replay_ms(loop, logits, cache, LONG_GEN)
        loop.load(logits, cache, 0)
        replays = device_profile(lambda: [loop.graph.replay() for _ in range(PROFILE_STEPS)],
                                 count=r"decode_split_")
    if replays["kernels_matching"][r"decode_split_"] != c.n_layer * PROFILE_STEPS:
        raise AssertionError(f"long path: the trace of {PROFILE_STEPS} replays holds "
                             f"{replays['kernels_matching']} decode kernels")
    err_prefill, scale, err_step, step_scale, finite = _long_vs_plain(LlamaModel, c, model, gen)
    decode_s = gen_s - prefill_med / 1e3
    eager_decode_s = eager_s - prefill_med / 1e3
    emit(f"slice {MODEL} long", batch=LONG_BATCH, prompt=LONG_PROMPT, gen=LONG_GEN,
         capacity=LONG_S, dtype="bfloat16", launches=launches,
         first_call_launches=first_launches, generate_s=gen_s,
         first_generate_s=first_s, capture_s=loop.capture_s, prefill_ms=prefill_med,
         decode_tok_s=LONG_BATCH * LONG_GEN / decode_s,
         decode_ms_per_step=decode_s * 1e3 / LONG_GEN, replay_device_ms_per_step=replay_ms,
         eager_decode_tok_s=LONG_BATCH * LONG_GEN / eager_decode_s,
         eager_decode_ms_per_step=eager_decode_s * 1e3 / LONG_GEN,
         eager_tokens_identical=same, tokens_differing=int((eager != out).sum().item()),
         finite_logits=bool(torch.isfinite(logits).all().item()) and finite,
         plain_prompt=LONG_S - 1, prefill_logits_max_abs_err=err_prefill,
         decode_logits_max_abs_err=err_step, ref_logits_max_abs=scale, logit_rtol=LOGIT_RTOL,
         profile_replays={"steps": PROFILE_STEPS, **replays})
    if not same or not torch.isfinite(logits).all():
        raise AssertionError("long path: graphed and eager greedy tokens differ, or the "
                             "prefill logits are not finite")
    if not finite or err_prefill > LOGIT_RTOL * scale or err_step > LOGIT_RTOL * step_scale:
        raise AssertionError(f"long path, kernel path vs plain path: prefill logits err "
                             f"{err_prefill}, decode logits err {err_step} at pos {LONG_S - 1}, "
                             f"|ref| max {scale}, {step_scale}")
    del engine, model, cache, loop
    torch.cuda.empty_cache()


def serve_sampled(init_inference, LlamaModel, cfg, da):
    """Sampled decode (top-k 50) at full width and 2 layers: two graphed
    calls with one seed give the same tokens, those of the ungraphed loop
    seeded alike; another seed gives others."""
    c = dataclasses.replace(cfg, n_layer=SMALL_LAYERS, use_flash_decode=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    model = LlamaModel(c).init_params(gen)
    engine = init_inference(model, {"dtype": "bfloat16"})
    ids = torch.randint(0, c.vocab_size, (SMALL_BATCH, SMALL_PROMPT), generator=gen,
                        device="cuda")
    kw = dict(do_sample=True, temperature=1.0, top_k=50)
    da.KERNEL.reset_launches()
    a = engine.generate(ids, max_new_tokens=SMALL_GEN, seed=7, **kw)
    launches = da.KERNEL.launches
    b = engine.generate(ids, max_new_tokens=SMALL_GEN, seed=7, **kw)
    other = engine.generate(ids, max_new_tokens=SMALL_GEN, seed=8, **kw)
    eager, _ = _eager_generate(engine, ids, SMALL_GEN, seed=7, **kw)
    loops = len(engine._decode_loops)
    ok = torch.equal(a, b) and torch.equal(a, eager) and not torch.equal(a, other) \
        and launches == SMALL_LAYERS * (SMALL_GEN + 1) and loops == 1   # + the warm-up step
    emit(f"slice {MODEL} sampled {SMALL_LAYERS}-layer", batch=SMALL_BATCH, prompt=SMALL_PROMPT,
         gen=SMALL_GEN, top_k=50, decode_launches=launches, decode_loops=loops,
         repeat_identical=torch.equal(a, b), eager_identical=torch.equal(a, eager),
         other_seed_differs=not torch.equal(a, other))
    if not ok:
        raise AssertionError("sampled graphed decode: not reproducible per seed, not the eager "
                             "loop's draws, or launches/loops off")


def kernel_category(name: str) -> str:
    """Coarse owner of a device kernel, by its name."""
    if re.search(r"flash_fwd_|flash_bwd_|decode_|sparse_fwd_|sparse_bwd_", name):
        return "port attention kernels"
    if re.search(r"gemm|nvjet|cutlass|xmma|cublas|splitK", name, re.I):
        return "matmul (cuBLAS)"
    if "at::native" in name or "Memcpy" in name or "Memset" in name:
        return "torch elementwise, reduction, copy"
    return "other"


def device_profile(fn, top: int = 6, count: str = None):
    """Run fn() under torch.profiler: host wall ms, device ms summed over
    kernels, the device's idle share of the wall time, device ms by kernel
    category, the top kernels, the number of host-to-device copies and of
    CUDA graph launches; with ``count``, the number of device kernels whose
    name matches it. The profiler's own overhead lengthens the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    dev = lambda e: e.self_device_time_total / 1e3     # us → ms
    rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=dev, reverse=True)
    device_ms = sum(dev(e) for e in rows)
    by_category = {}
    for e in rows:
        cat = kernel_category(e.key)
        by_category[cat] = by_category.get(cat, 0.0) + dev(e)
    htod = sum(e.count for e in prof.key_averages() if "HtoD" in e.key)
    memcpy_ms = {d: sum(dev(e) for e in rows if f"Memcpy {d}" in e.key) for d in ("HtoD", "DtoH")}
    graph_keys = {e.key: e.count for e in prof.key_averages() if "Graph" in e.key}
    graphs = sum(n for key, n in graph_keys.items() if key.startswith("cudaGraphLaunch"))
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "idle_share": max(0.0, 1 - device_ms / wall_ms), "by_category": by_category,
           "top": [[e.key[:70], dev(e), e.count] for e in rows[:top]], "htod_copies": htod,
           "memcpy_ms": memcpy_ms,
           "graph_launches": graphs, "graph_events": graph_keys}
    if count:
        out["kernels_matching"] = {count: sum(e.count for e in rows if re.search(count, e.key))}
    return out


def profile_slice(model, engine, loop, ids, logits, cache, n_layer):
    """Where the time goes: one prefill; PROFILE_STEPS replays of the
    captured decode step beside PROFILE_STEPS eager decode steps; and one
    whole graphed generate. The traces confirm the credited count n_layer x
    GEN: the replays' trace must hold exactly n_layer decode kernels per
    graph launch, and the generate's exactly GEN graph launches. The
    generate's own decode-kernel count must be above 0 and at most the
    credited one: its trace of ~40k kernels lost 30 kernel records in one of
    four runs on an H100, so it is reported, not held equal."""
    tok = torch.argmax(logits, dim=-1)

    def decode():
        nonlocal tok
        state = cache
        for _ in range(PROFILE_STEPS):
            step_logits, state = model.decode_step(tok, state)
            tok = torch.argmax(step_logits, dim=-1)

    def replays():
        for _ in range(PROFILE_STEPS):
            loop.graph.replay()

    prefill = device_profile(lambda: model.prefill(ids, model.init_cache(BATCH, PROMPT + GEN)))
    graphed_logits, graphed_cache = model.prefill(ids, loop.cache)
    loop.load(graphed_logits, graphed_cache, 0)
    graphed = device_profile(replays, count=r"decode_split_")
    eager = device_profile(decode, count=r"decode_split_")
    whole = device_profile(lambda: engine.generate(ids, max_new_tokens=GEN), top=0,
                           count=r"decode_split_")
    seen = whole["kernels_matching"][r"decode_split_"]
    per_replay = graphed["kernels_matching"][r"decode_split_"] / max(1, graphed["graph_launches"])
    traced = whole["graph_launches"] * per_replay
    emit(f"profile {MODEL}", prefill=prefill, decode_steps=PROFILE_STEPS,
         decode_graphed=graphed, decode=eager, generate_graphed=whole,
         profiler_decode_kernels=seen, profiler_decode_kernels_per_replay=per_replay,
         profiler_graph_launches=whole["graph_launches"], traced_decode_launches=traced,
         credited_decode_launches=n_layer * GEN, trace_lost_records=n_layer * GEN - seen)
    if graphed["graph_launches"] != PROFILE_STEPS or per_replay != n_layer \
            or traced != n_layer * GEN or not 0 < seen <= n_layer * GEN:
        raise AssertionError(f"the traces do not confirm {n_layer * GEN} decode launches: "
                             f"{per_replay} per replay over {whole['graph_launches']} graph "
                             f"launches; {seen} decode kernels in the generate's trace")


def serve_small_fp32(init_inference, LlamaModel, cfg):
    """fp32, full width, 2 layers: greedy tokens of the kernel path and the
    plain path must be identical."""
    c = dataclasses.replace(cfg, n_layer=SMALL_LAYERS, dtype=torch.float32,
                            use_flash_decode=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    model = LlamaModel(c).init_params(gen)
    ids = torch.randint(0, c.vocab_size, (SMALL_BATCH, SMALL_PROMPT), generator=gen,
                        device="cuda")
    eng = init_inference(model, {"dtype": "float32"})
    plain = LlamaModel(dataclasses.replace(c, use_flash_attention=False, use_flash_decode=False))
    eng_p = init_inference(plain, {"dtype": "float32"}, params=model.state_dict())
    out = eng.generate(ids, max_new_tokens=SMALL_GEN)
    out_p = eng_p.generate(ids, max_new_tokens=SMALL_GEN)
    same = torch.equal(out, out_p)
    emit(f"slice {MODEL} fp32 {SMALL_LAYERS}-layer", batch=SMALL_BATCH, prompt=SMALL_PROMPT,
         gen=SMALL_GEN, tokens_identical=same,
         tokens_differing=int((out != out_p).sum().item()))
    if not same:
        raise AssertionError("fp32 greedy tokens differ between the kernel and plain paths")


def serve_small_fp16(init_inference, LlamaModel, cfg, fa, da):
    """fp16, full width, 2 layers, through generate with the decode kernel:
    each layer launches the flash kernel once and the decode kernel once per
    new token and warm-up step, and the kernel path's logits agree with the
    plain path's at prefill and at one decode step."""
    c = dataclasses.replace(cfg, n_layer=SMALL_LAYERS, dtype=torch.float16,
                            use_flash_decode=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    model = LlamaModel(c).init_params(gen)
    ids = torch.randint(0, c.vocab_size, (SMALL_BATCH, SMALL_PROMPT), generator=gen,
                        device="cuda")
    eng = init_inference(model, {"dtype": "fp16"})
    plain = LlamaModel(dataclasses.replace(c, use_flash_attention=False, use_flash_decode=False))
    eng_p = init_inference(plain, {"dtype": "fp16"}, params=model.state_dict())
    fa.KERNEL.reset_launches()
    da.KERNEL.reset_launches()
    out = eng.generate(ids, max_new_tokens=SMALL_GEN)
    launches = {"flash_attention_fwd": fa.KERNEL.launches, "decode_attention": da.KERNEL.launches}
    out_p = eng_p.generate(ids, max_new_tokens=SMALL_GEN)
    # the first call with its key: the warm-up step before the capture ran too
    expect = {"flash_attention_fwd": SMALL_LAYERS,
              "decode_attention": SMALL_LAYERS * (SMALL_GEN + 1)}
    with torch.inference_mode():
        logits, cache = model.prefill(ids, model.init_cache(SMALL_BATCH, SMALL_PROMPT + SMALL_GEN))
        ref, ref_cache = plain.prefill(ids, plain.init_cache(SMALL_BATCH,
                                                             SMALL_PROMPT + SMALL_GEN))
        tok = torch.argmax(ref, dim=-1)
        step_k, _ = model.decode_step(tok, cache)
        step_p, _ = plain.decode_step(tok, ref_cache)
    err_prefill, err_step = max_err(logits, ref), max_err(step_k, step_p)
    scale, step_scale = ref.abs().max().item(), step_p.abs().max().item()
    emit(f"slice {MODEL} fp16 {SMALL_LAYERS}-layer", batch=SMALL_BATCH, prompt=SMALL_PROMPT,
         gen=SMALL_GEN, launches=launches, prefill_logits_max_abs_err=err_prefill,
         decode_logits_max_abs_err=err_step, ref_logits_max_abs=scale, logit_rtol=LOGIT_RTOL,
         tokens_identical=torch.equal(out, out_p),
         tokens_differing=int((out != out_p).sum().item()))
    if launches != expect or tuple(out.shape) != (SMALL_BATCH, SMALL_PROMPT + SMALL_GEN):
        raise AssertionError(f"fp16 generate: launches {launches}, expected {expect}; "
                             f"output {tuple(out.shape)}")
    if not (torch.isfinite(logits).all() and torch.isfinite(step_k).all()) \
            or err_prefill > LOGIT_RTOL * scale or err_step > LOGIT_RTOL * step_scale:
        raise AssertionError(f"fp16 kernel path vs plain path: prefill logits err {err_prefill}, "
                             f"decode logits err {err_step}, |ref| max {scale}")


# -------------------------------------------------------------------- train
def _grads(model, batch):
    model.zero_grad(set_to_none=True)
    loss = model.loss(batch)
    loss.backward()
    return loss.detach().float(), {n: p.grad.float() for n, p in model.named_parameters()}


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def _dense_plain(model):
    """The dense path's plain version: the model's own flag."""
    model.config = dataclasses.replace(model.config, use_flash_attention=False)


def _sparse_plain(fa, model, block: dict, seq: int):
    """The sparse path's plain version, swapped in here only (the package has
    no switch for it): the model's block-sparse attention becomes
    ``sparse_mha_reference`` under the same layout."""
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention

    layout = sparse_self_attention(block, model.config.n_head).get_layout(seq)
    model._sparse_attention = lambda q, k, v: fa.sparse_mha_reference(q, k, v, layout)


def _timed_steps(engine, batch, accel, kernels):
    """TRAIN_WARMUP steps, then the counts of ``kernels`` set to 0 and
    TRAIN_STEPS timed steps. → (losses, step ms each, peak GB)."""
    losses = [float(engine.train_batch(batch)) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    accel.reset_peak_memory_stats()
    for kern in kernels:
        kern.reset_launches()
    step_ms = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))   # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not falling: {losses}")
    return losses, step_ms, accel.max_memory_allocated() / 1e9


def _train_line(c, batch, seq, step_ms, accel):
    step_s = sorted(step_ms)[TRAIN_STEPS // 2] / 1e3              # the median step
    tokens = batch * seq
    flops = c.flops_per_token(seq) * tokens
    return dict(batch=batch, seq=seq, gas=1, dtype="bfloat16", params=c.num_params(),
                warmup_steps=TRAIN_WARMUP, timed_steps=TRAIN_STEPS, step_ms=step_s * 1e3,
                step_ms_each=step_ms, tokens_per_s=tokens / step_s,
                mfu=flops / step_s / accel.peak_flops(torch.bfloat16),
                model_tflop_per_step=flops / 1e12)


def train_slice(initialize, GPT2Model, cfg, accel, fa):
    """gpt2-760m, bf16, full width and depth, through initialize →
    train_batch: the counted main-path run of the dense training slice."""
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    c = dataclasses.replace(cfg, remat=False)
    engine, *_ = initialize(model=GPT2Model(c), config=dict(TRAIN_CONFIG))
    batch = synthetic_lm_batch(TRAIN_BATCH, TRAIN_SEQ, c.vocab_size, seed=SEED, device="cuda")
    losses, step_ms, peak_gb = _timed_steps(engine, batch, accel, (fa.KERNEL, fa.BWD_KERNEL))
    launches = {"flash_attention_fwd": fa.KERNEL.launches, **fa.BWD_KERNEL.entry_launches}
    expect = dict.fromkeys(launches, c.n_layer * TRAIN_STEPS)
    if launches != expect:
        raise AssertionError(f"launch counts {launches} over {TRAIN_STEPS} steps, "
                             f"expected {expect} ({c.n_layer} per microbatch)")
    emit(f"train {TRAIN_MODEL}", **_train_line(c, TRAIN_BATCH, TRAIN_SEQ, step_ms, accel),
         peak_mem_gb=peak_gb, losses=losses,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         grad_norm=engine.get_global_grad_norm(), lr=engine.get_lr()[0])
    emit(f"profile train {TRAIN_MODEL}",
         step=device_profile(lambda: engine.train_batch(batch), top=12))
    del engine
    torch.cuda.empty_cache()
    return launches, batch


def train_sparse_slice(initialize, GPT2Model, cfg, accel, fa):
    """gpt2-1.3b, bf16, full width and depth, 2048 tokens, through
    initialize(config={..., "sparse_attention": ...}) → train_batch: the
    counted main-path run of the block-sparse slice. Each step must launch
    each sparse kernel once per layer and no dense flash kernel."""
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    c = dataclasses.replace(cfg, remat=False)
    model = GPT2Model(c)
    config = {**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": SPARSE_BATCH,
              "sparse_attention": dict(SPARSE_BLOCK)}
    engine, *_ = initialize(model=model, config=config)
    if model.config.sparse_attention != SPARSE_BLOCK:
        raise AssertionError(f"initialize did not carry the block: {model.config.sparse_attention}")
    batch = synthetic_lm_batch(SPARSE_BATCH, SPARSE_SEQ, c.vocab_size, seed=SEED, device="cuda")
    losses, step_ms, peak_gb = _timed_steps(engine, batch, accel,
                                            (fa.KERNEL, fa.BWD_KERNEL, fa.SPARSE_KERNEL))
    launches = {**fa.SPARSE_KERNEL.entry_launches,
                "flash_attention_fwd": fa.KERNEL.launches,
                "flash_attention_bwd": fa.BWD_KERNEL.launches}
    expect = {**dict.fromkeys(fa.SPARSE_KERNEL.entry_launches, c.n_layer * TRAIN_STEPS),
              "flash_attention_fwd": 0, "flash_attention_bwd": 0}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} over {TRAIN_STEPS} steps, "
                             f"expected {expect}")
    pairs = fa.sparse_pairs(model._sparse.get_layout(SPARSE_SEQ), True, SPARSE_SEQ, "cuda")
    attn_dense = 12 * c.n_layer * c.n_embd * SPARSE_SEQ * SPARSE_BATCH * SPARSE_SEQ
    attn_sparse = 12 * c.head_dim * pairs.visible * c.n_head * SPARSE_BATCH * c.n_layer
    emit(f"train {SPARSE_MODEL} sparse-fixed16",
         **_train_line(c, SPARSE_BATCH, SPARSE_SEQ, step_ms, accel),
         sparse_attention=SPARSE_BLOCK, layout_blocks=pairs.n, pairs=int(pairs.row_cols_np.size),
         visible_pairs_per_head=pairs.visible,
         attention_tflop_dense_accounting=attn_dense / 1e12,
         attention_tflop_sparse_pairs=attn_sparse / 1e12,
         peak_mem_gb=peak_gb, losses=losses,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         grad_norm=engine.get_global_grad_norm(), lr=engine.get_lr()[0])
    cached = len(fa._PAIRS)
    prof = device_profile(lambda: engine.train_batch(batch), top=12)
    emit(f"profile train {SPARSE_MODEL} sparse-fixed16", step=prof,
         pair_lists_built_in_step=len(fa._PAIRS) - cached)
    if prof["htod_copies"] or len(fa._PAIRS) != cached:
        raise AssertionError(f"host-to-device copies in the sparse step: {prof['htod_copies']}, "
                             f"pair lists built: {len(fa._PAIRS) - cached}")
    del engine, model
    torch.cuda.empty_cache()
    return launches, batch


def train_check_bf16(GPT2Model, cfg, batch, label, to_plain):
    """One bf16 step's loss and every gradient, kernel path against plain
    path (``to_plain`` swaps the model's attention) on the same weights and
    batch."""
    model = GPT2Model(cfg).init_params(torch.Generator(device="cuda").manual_seed(SEED))
    model.to(dtype=torch.bfloat16)
    loss_k, grads_k = _grads(model, batch)
    to_plain(model)
    loss_p, grads_p = _grads(model, batch)
    rel = {n: _rel_l2(grads_k[n], grads_p[n]) for n in grads_k}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    finite = all(torch.isfinite(g).all().item() for g in grads_k.values())
    emit(f"train check {label} bf16", layers=cfg.n_layer, remat=cfg.remat,
         loss_kernel=loss_k.item(), loss_plain=loss_p.item(), loss_rel_diff=loss_rel,
         loss_rtol=TRAIN_LOSS_RTOL, grad_rel_l2_max=rel[worst], grad_rel_l2_worst=worst,
         grad_rel_l2_median=sorted(rel.values())[len(rel) // 2], grad_rtol=TRAIN_GRAD_RTOL)
    if not finite or loss_rel > TRAIN_LOSS_RTOL or rel[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError(f"bf16 kernel path vs plain path: loss rel {loss_rel}, "
                             f"grad {worst} rel {rel[worst]}")
    del model, grads_k, grads_p
    torch.cuda.empty_cache()


def train_check_fp32(initialize, GPT2Model, cfg, label, seq, extra_config, to_plain):
    """fp32, full width, 2 layers, B=2, gas=2: three AdamW steps through the
    engine on the kernel path and the plain path (``to_plain`` swaps the
    model's attention before the engine is built)."""
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    k = CHECK_FP32
    c = dataclasses.replace(cfg, n_layer=k["layers"], remat=False, dtype=torch.float32)
    init = GPT2Model(c).init_params(torch.Generator(device="cuda").manual_seed(SEED + 1))
    config = {"train_batch_size": k["batch"] * k["gas"], "gradient_accumulation_steps": k["gas"],
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}},
              "gradient_clipping": 1.0, "steps_per_print": 0, **extra_config}
    batch = synthetic_lm_batch(k["batch"] * k["gas"], seq, c.vocab_size, seed=SEED + 1,
                               device="cuda")
    runs = {}
    for path in ("kernel", "plain"):
        model = GPT2Model(c)
        if path == "plain":
            to_plain(model)
        engine, *_ = initialize(model=model, config=dict(config),
                                model_parameters={n: t.clone()
                                                  for n, t in init.state_dict().items()})
        losses = [float(engine.train_batch(batch)) for _ in range(k["steps"])]
        runs[path] = (losses, {n: p.detach().clone() for n, p in model.named_parameters()})
        del engine
    (lk, pk), (lp, pp) = runs["kernel"], runs["plain"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    flat = lambda ps: torch.cat([t.flatten() for t in ps.values()])
    param_rel = _rel_l2(flat(pk), flat(pp))
    rel = {n: _rel_l2(pk[n], pp[n]) for n in pk}
    worst = max(rel, key=rel.get)
    emit(f"train check {label} fp32 {k['layers']}-layer", seq=seq, **k,
         losses_kernel=lk, losses_plain=lp, loss_rel_diff=loss_rel, param_rel_l2=param_rel,
         rtol=FP32_RTOL, per_tensor_rel_l2_max=rel[worst], per_tensor_rel_l2_worst=worst)
    if loss_rel > FP32_RTOL or param_rel > FP32_RTOL:
        raise AssertionError(f"fp32 kernel path vs plain path: loss rel {loss_rel}, "
                             f"params rel {param_rel}")
    del runs, pk, pp
    torch.cuda.empty_cache()



# --------------------------------------------------------------------- ZeRO
def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _counted_step(comm, engine, batch) -> tuple:
    """One step with the CommsLogger on: (its ms, {op: calls and bytes})."""
    from deepspeed_tpu_torch.comm import comm as comm_module

    comm.configure(enabled=True)
    try:
        t0 = time.perf_counter()
        float(engine.train_batch(batch))
        step_ms = (time.perf_counter() - t0) * 1e3
        totals = comm_module.comms_logger.totals()
    finally:
        comm.configure(enabled=False)
    return step_ms, {op: {"calls": v["calls"], "bytes": v["bytes"]} for op, v in totals.items()}


def _state_to_host(engine) -> dict:
    """A save's gather: the engine's whole state copied to the host, and
    the card's peak above the state while it ran, held to the largest
    unit's fp32 buffer (the state is gathered one unit at a time)."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import flatten_state

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = flatten_state(engine)
    seconds = time.perf_counter() - t0
    above = torch.cuda.max_memory_allocated() - before
    unit = 4 * max(u.length for u in engine._plan.units)
    host = sum(t.numel() * t.element_size() for t in state.values())
    del state
    if above > unit + 2 ** 20:
        raise AssertionError(f"the state's gather held {above} B above the state, more than "
                             f"the largest unit's {unit} B")
    return {"to_host_s": seconds, "to_host_gb": host / 1e9,
            "to_host_peak_above_state_gb": above / 1e9, "largest_unit_fp32_gb": unit / 1e9}


def zero_check_fp32(initialize, GPT2Model, cfg):
    """fp32, full width, 2 layers, B=2, gas=2: three AdamW steps at ZeRO
    stage 3 against stage 0 on the same weights and batch, held as
    train_check_fp32 holds the kernel path to the plain path."""
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    k = CHECK_FP32
    c = dataclasses.replace(cfg, n_layer=k["layers"], remat=False, dtype=torch.float32)
    init = GPT2Model(c).init_params(torch.Generator(device="cuda").manual_seed(SEED + 1))
    config = {"train_batch_size": k["batch"] * k["gas"], "gradient_accumulation_steps": k["gas"],
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}},
              "gradient_clipping": 1.0, "steps_per_print": 0}
    batch = synthetic_lm_batch(k["batch"] * k["gas"], TRAIN_SEQ, c.vocab_size, seed=SEED + 1,
                               device="cuda")
    runs = {}
    for stage in (0, 3):
        engine, *_ = initialize(model=GPT2Model(c),
                                config={**config, "zero_optimization": {"stage": stage}},
                                model_parameters={n: t.clone()
                                                  for n, t in init.state_dict().items()})
        losses = [float(engine.train_batch(batch)) for _ in range(k["steps"])]
        runs[stage] = (losses, {n: t.cuda() for n, t in engine.module_state_dict().items()})
        del engine
    (l0, p0), (l3, p3) = runs[0], runs[3]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l3, l0))
    flat = lambda ps: torch.cat([ps[n].flatten() for n in sorted(ps)])
    param_rel = _rel_l2(flat(p3), flat(p0))
    emit(f"train check {TRAIN_MODEL} zero3 fp32 {k['layers']}-layer", **k, seq=TRAIN_SEQ,
         losses_stage0=l0, losses_stage3=l3, loss_rel_diff=loss_rel, param_rel_l2=param_rel,
         rtol=FP32_RTOL)
    if loss_rel > FP32_RTOL or param_rel > FP32_RTOL:
        raise AssertionError(f"fp32 stage 3 vs stage 0: loss rel {loss_rel}, params rel "
                             f"{param_rel}")
    del runs, p0, p3, init
    torch.cuda.empty_cache()


def zero_slice(initialize, GPT2Model, cfg, accel, fa):
    """gpt2-760m, bf16 with fp32 masters, full width and depth, through
    initialize → train_batch over a NCCL process group of one (every
    collective of the stage runs), at ZeRO stages 0-3: each stage's steps,
    collectives per step (CommsLogger, on one extra step), stage-3 gathers,
    peak memory and kernel launches; the losses held to stage 0's."""
    import gc

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch
    from deepspeed_tpu_torch.runtime.zero.partition import partition_report

    comm.init_distributed(init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1,
                          timeout=600)
    try:
        backend = comm.get_backend()
        if backend != "nccl" or comm.get_world_size() != 1:
            raise AssertionError(f"process group {backend} of {comm.get_world_size()}")
        c = dataclasses.replace(cfg, remat=False)
        batch = synthetic_lm_batch(TRAIN_BATCH, TRAIN_SEQ, c.vocab_size, seed=SEED,
                                   device="cuda")
        losses, launches = {}, {}
        for stage in ZERO_STAGES:
            config = {**TRAIN_CONFIG, "zero_optimization": {"stage": stage}}
            engine, *_ = initialize(model=GPT2Model(c), config=config)
            losses[stage], step_ms, peak_gb = _timed_steps(engine, batch, accel,
                                                           (fa.KERNEL, fa.BWD_KERNEL))
            launches[stage] = {"flash_attention_fwd": fa.KERNEL.launches,
                               **fa.BWD_KERNEL.entry_launches}
            expect = dict.fromkeys(launches[stage], c.n_layer * TRAIN_STEPS)
            if launches[stage] != expect:
                raise AssertionError(f"stage {stage}: launch counts {launches[stage]} over "
                                     f"{TRAIN_STEPS} steps, expected {expect}")
            gathers = engine._zero.gathers / (TRAIN_WARMUP + TRAIN_STEPS)
            logged_ms, collectives = _counted_step(comm, engine, batch)
            save = _state_to_host(engine)
            emit(f"train {TRAIN_MODEL} zero{stage}", backend=backend,
                 world=comm.get_world_size(), zero_stage=stage,
                 partition=partition_report(engine._plan), units=len(engine._plan.units),
                 **_train_line(c, TRAIN_BATCH, TRAIN_SEQ, step_ms, accel),
                 peak_mem_gb=peak_gb, losses=losses[stage],
                 launches_per_step={k: v / TRAIN_STEPS for k, v in launches[stage].items()},
                 collectives_per_step=collectives,
                 collective_bytes_per_step=sum(v["bytes"] for v in collectives.values()),
                 logged_step_ms=logged_ms, stage3_gathers_per_step=gathers, **save,
                 grad_norm=engine.get_global_grad_norm(), lr=engine.get_lr()[0])
            emit(f"profile train {TRAIN_MODEL} zero{stage}",
                 step=device_profile(lambda: engine.train_batch(batch), top=12))
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        rel = {s: max(abs(a - b) / abs(b) for a, b in zip(losses[s], losses[0]))
               for s in ZERO_STAGES}
        emit(f"check {TRAIN_MODEL} zero losses", loss_rel_to_stage0=rel, rtol=TRAIN_LOSS_RTOL)
        if max(rel.values()) > TRAIN_LOSS_RTOL:
            raise AssertionError(f"ZeRO stage losses vs stage 0: {rel}")
        zero_check_fp32(initialize, GPT2Model, cfg)
    finally:
        comm.destroy_process_group()
    return launches


def check_head_dim_80(initialize, GPT2Model, cfg, fa):
    """gpt2-2.7b (head dim 80) at full width and 2 layers, dense at
    TRAIN_SEQ and with the sparse block at SPARSE_SEQ: the bf16 loss and
    gradients and three fp32 engine steps, kernel path against plain path
    at the training checks' tolerances. The bf16 kernel path must launch
    each of its kernels once per layer."""
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    c = dataclasses.replace(cfg, n_layer=2, remat=False)
    kernels = (fa.KERNEL, fa.BWD_KERNEL, fa.SPARSE_KERNEL)
    for label, seq, block in (("dense", TRAIN_SEQ, None),
                              ("sparse-fixed16", SPARSE_SEQ, SPARSE_BLOCK)):
        to_plain = _dense_plain if block is None else \
            (lambda m, seq=seq: _sparse_plain(fa, m, SPARSE_BLOCK, seq))
        batch = synthetic_lm_batch(2, seq, c.vocab_size, seed=SEED, device="cuda")
        for kern in kernels:
            kern.reset_launches()
        train_check_bf16(GPT2Model, dataclasses.replace(c, sparse_attention=block), batch,
                         f"gpt2-2.7b head-dim-80 {label}", to_plain)
        launches = {n: v for kern in kernels for n, v in kern.entry_launches.items() if v}
        want = dict.fromkeys(fa.SPARSE_KERNEL.entry_launches if block else
                             ("flash_attention_fwd", "flash_attention_bwd_dq",
                              "flash_attention_bwd_dkv"), c.n_layer)
        emit(f"check gpt2-2.7b head-dim-80 {label} launches", launches=launches, expected=want)
        if launches != want:
            raise AssertionError(f"head dim 80 {label}: launches {launches}, expected {want}")
        train_check_fp32(initialize, GPT2Model, cfg, f"gpt2-2.7b head-dim-80 {label}", seq,
                         {"sparse_attention": dict(block)} if block else {}, to_plain)


# ------------------------------------------------------ feed, save, resume

def _scratch_dir():
    """The candidate directory (the temp dir, the checkout) with the most
    free space, and every candidate's free bytes."""
    free = {d: shutil.disk_usage(d).free
            for d in (tempfile.gettempdir(), os.path.dirname(os.path.abspath(__file__)))}
    best = max(free, key=free.get)
    return best, free


def _token_dataset(tmp: str, vocab: int):
    """RESUME_SAMPLES rows of TRAIN_SEQ int32 tokens from SEED, written with
    the port's indexed-dataset builder and read back memory-mapped."""
    from deepspeed_tpu_torch.runtime.data_pipeline.indexed_dataset import (
        MMapIndexedDataset, MMapIndexedDatasetBuilder)

    prefix = os.path.join(tmp, "tokens")
    builder = MMapIndexedDatasetBuilder(prefix, dtype=np.int32)
    rng = np.random.default_rng(SEED)
    for _ in range(RESUME_SAMPLES):
        builder.add_item(rng.integers(0, vocab, size=TRAIN_SEQ, dtype=np.int32))
    builder.finalize()
    return MMapIndexedDataset(prefix)


def _fed_steps(engine, it, n: int) -> dict:
    """n steps, each batch taken from the loader's iterator (collate
    included) and then trained on: the losses, the batches, the data wait
    and the step time (to the loss on the host), in ms."""
    out = {"losses": [], "batches": [], "wait_ms": [], "step_ms": []}
    for _ in range(n):
        t0 = time.perf_counter()
        batch = next(it)
        t1 = time.perf_counter()
        out["losses"].append(float(engine.train_batch(batch)))
        out["step_ms"].append((time.perf_counter() - t1) * 1e3)
        out["wait_ms"].append((t1 - t0) * 1e3)
        out["batches"].append(batch)
    return out


def _bitwise_equal(a, b) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    return torch.equal(a, b)


def _checksum(engine) -> float:
    return sum(p.detach().double().sum().item() for p in engine.module.parameters())


def _tree_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _evict_from_page_cache(path: str) -> None:
    """Drop the tag's clean pages from the page cache, so the next load
    reads the disk and not memory."""
    for d, _, fs in os.walk(path):
        for f in fs:
            fd = os.open(os.path.join(d, f), os.O_RDONLY)
            try:
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)


def _disk_rates(tmp: str, gib: int = 2) -> dict:
    """What the disk gives without the checkpoint engine: ``gib`` GiB
    written in 64 MiB chunks and fsynced, then read back after the pages
    were dropped from the page cache, in GB/s."""
    path, chunk = os.path.join(tmp, "disk_probe"), np.ones(64 * 2**20, np.uint8)
    n = gib * 16
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        for _ in range(n):
            f.write(chunk)
        f.flush()
        os.fsync(f.fileno())
    write_s = time.perf_counter() - t0
    _evict_from_page_cache(tmp)
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        while f.readinto(chunk):
            pass
    read_s = time.perf_counter() - t0
    os.remove(path)
    return {"probe_bytes": n * chunk.size, "disk_write_gb_per_s": n * chunk.size / write_s / 1e9,
            "disk_read_gb_per_s": n * chunk.size / read_s / 1e9}


def resume_slice(initialize, GPT2Model, cfg, accel, fa, dataset, tmp):
    """gpt2-760m, bf16, full width, through initialize(training_data=...):
    engine A trains RESUME_STEPS steps through its loader, saves (async, the
    default), trains RESUME_STEPS more; engines B and C, each built from
    another seed, load the tag and train RESUME_STEPS steps through their
    own restored loaders. The state right after each load must equal A's at
    the save bit for bit; B must see A's later batches; B's losses must be
    as close to A's as to C's (bitwise when B and C are); every step must
    launch each dense kernel once per layer."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (flatten_state,
                                                                       wait_for_pending_saves)

    c = dataclasses.replace(cfg, remat=False)
    ckpt = os.path.join(tmp, "ckpt")
    kernels = (fa.KERNEL, fa.BWD_KERNEL)
    for kern in kernels:
        kern.reset_launches()
    a, _, loader, _ = initialize(model=GPT2Model(c), config=dict(TRAIN_CONFIG),
                                 training_data=dataset)
    it = iter(loader)
    first = _fed_steps(a, it, RESUME_STEPS)
    saved = {k: v.clone() for k, v in flatten_state(a).items()}
    saved_lr, saved_loader = a.get_lr()[0], a.dataloader.state_dict()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.save_checkpoint(ckpt)
    blocking_s = time.perf_counter() - t0
    later = _fed_steps(a, it, RESUME_STEPS)      # while the commit writes
    sum_a = _checksum(a)
    wait_for_pending_saves()
    record = dict(a._last_save)
    if "error" in record or "commit_s" not in record:
        raise AssertionError(f"the async save did not commit: {record}")
    tag_bytes = _tree_bytes(record["path"])
    del a, it, loader
    torch.cuda.empty_cache()

    runs = {}
    for name, seed, cold in (("B", SEED + 1, True), ("C", SEED + 2, False)):
        engine, _, ld, _ = initialize(model=GPT2Model(c), config={**TRAIN_CONFIG, "seed": seed},
                                      training_data=dataset)
        if cold:
            _evict_from_page_cache(record["path"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path, _ = engine.load_checkpoint(ckpt)
        load_s = time.perf_counter() - t0
        restored = flatten_state(engine)
        differ = sorted(k for k in saved if k not in restored
                        or not _bitwise_equal(restored[k], saved[k]))
        if restored.keys() != saved.keys() or differ or engine.get_lr()[0] != saved_lr \
                or ld.state_dict() != saved_loader or path != record["path"]:
            raise AssertionError(f"engine {name}: the state after load differs from the saved "
                                 f"state: {len(differ)} tensors ({differ[:4]}), lr "
                                 f"{engine.get_lr()[0]} vs {saved_lr}, loader "
                                 f"{ld.state_dict()} vs {saved_loader}")
        del restored
        r = _fed_steps(engine, iter(ld), RESUME_STEPS)
        if not all(np.array_equal(x, y) for x, y in zip(r["batches"], later["batches"])):
            raise AssertionError(f"engine {name} did not see engine A's steps "
                                 f"{RESUME_STEPS + 1}-{2 * RESUME_STEPS} batches")
        runs[name] = dict(r, load_s=load_s, read_gb_per_s=tag_bytes / load_s / 1e9,
                          page_cache="evicted" if cold else "warm", checksum=_checksum(engine),
                          restore_s=engine._last_recovery["restore_s"])
        del engine, ld
        torch.cuda.empty_cache()
    del saved

    steps = 4 * RESUME_STEPS                      # A: 2, B: 1, C: 1 rounds
    launches = {"flash_attention_fwd": fa.KERNEL.launches, **fa.BWD_KERNEL.entry_launches}
    expect = dict.fromkeys(launches, c.n_layer * steps)
    la, lb, lc = later["losses"], runs["B"]["losses"], runs["C"]["losses"]
    d_ab = max(abs(x - y) for x, y in zip(la, lb))
    d_bc = max(abs(x - y) for x, y in zip(lb, lc))
    bc_bitwise = lb == lc and runs["B"]["checksum"] == runs["C"]["checksum"]
    close = (la == lb and sum_a == runs["B"]["checksum"]) if bc_bitwise else d_ab <= d_bc
    waits = first["wait_ms"] + later["wait_ms"]
    step_ms = first["step_ms"] + later["step_ms"]
    emit(f"resume {TRAIN_MODEL}", layers=c.n_layer, params=c.num_params(),
         samples=RESUME_SAMPLES, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
         losses_a=first["losses"] + la, losses_b=lb, losses_c=lc,
         checksum_a=sum_a, checksum_b=runs["B"]["checksum"], checksum_c=runs["C"]["checksum"],
         b_c_bitwise=bc_bitwise, max_loss_diff_a_b=d_ab, max_loss_diff_b_c=d_bc,
         state_bitwise_after_load=True, same_batches=True,
         tag_bytes=tag_bytes, tag_bytes_predicted=STATE_BYTES_PER_PARAM * c.num_params(),
         state_bytes=record["bytes"], save_blocking_s=blocking_s, commit_s=record["commit_s"],
         write_s=record["write_s"], write_gb_per_s=record["bytes"] / record["write_s"] / 1e9,
         load_s={n: r["load_s"] for n, r in runs.items()},
         restore_s={n: r["restore_s"] for n, r in runs.items()},
         read_gb_per_s={n: r["read_gb_per_s"] for n, r in runs.items()},
         page_cache={n: r["page_cache"] for n, r in runs.items()},
         data_wait_ms_each=waits, data_wait_ms_median=sorted(waits)[len(waits) // 2],
         step_ms_a_each=step_ms, step_ms_during_commit=later["step_ms"],
         step_ms_b=runs["B"]["step_ms"], step_ms_c=runs["C"]["step_ms"],
         launches=launches, launches_expected=expect)
    if launches != expect:
        raise AssertionError(f"launch counts {launches} over {steps} steps, expected {expect}")
    if not close or not all(math.isfinite(x) for x in la + lb + lc):
        raise AssertionError(f"resumed losses: A {la}, B {lb}, C {lc} (B and C bitwise: "
                             f"{bc_bitwise}; |A-B| {d_ab}, |B-C| {d_bc})")
    return launches


def curriculum_lengths() -> list:
    """T at each of the curriculum phase's steps, from the port's scheduler."""
    from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import \
        CurriculumScheduler

    sched = CurriculumScheduler(CURRICULUM)
    return [sched.get_difficulty(s) for s in range(1, CURRICULUM_STEPS + 1)]


def curriculum_slice(initialize, GPT2Model, cfg, fa, dataset):
    """gpt2-760m with the legacy curriculum_learning block, CURRICULUM_STEPS
    steps through the loader: T follows the schedule through ragged lengths
    up to TRAIN_SEQ, and every step launches each dense kernel once per
    layer. The data wait counts the host truncation too: it runs inside
    train_batch, so it is timed again apart from the step on the same
    batch."""
    from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling import apply_seqlen_curriculum
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    c = dataclasses.replace(cfg, remat=False)
    engine, _, loader, _ = initialize(
        model=GPT2Model(c), config={**TRAIN_CONFIG, "curriculum_learning": dict(CURRICULUM)},
        training_data=dataset)
    it = iter(RepeatingLoader(loader))
    kernels = (fa.KERNEL, fa.BWD_KERNEL)
    for kern in kernels:
        kern.reset_launches()
    counts = lambda: {"flash_attention_fwd": fa.KERNEL.launches, **fa.BWD_KERNEL.entry_launches}
    steps, seen = [], counts()
    for _ in range(CURRICULUM_STEPS):
        r = _fed_steps(engine, it, 1)
        now = counts()
        t = engine.curriculum_scheduler.get_current_difficulty()
        t0 = time.perf_counter()
        apply_seqlen_curriculum(r["batches"][0], t)
        cut_ms = (time.perf_counter() - t0) * 1e3
        steps.append({"T": t, "step_ms": r["step_ms"][0],
                      "data_wait_ms": r["wait_ms"][0] + cut_ms, "next_ms": r["wait_ms"][0],
                      "truncate_ms": cut_ms, "loss": r["losses"][0],
                      "launches": {k: now[k] - seen[k] for k in now}})
        seen = now
    want_t = curriculum_lengths()
    emit(f"curriculum {TRAIN_MODEL}", schedule=CURRICULUM, steps=steps, expected_T=want_t)
    bad = [s for s in steps if s["launches"] != dict.fromkeys(s["launches"], c.n_layer)]
    if [s["T"] for s in steps] != want_t or bad \
            or not all(math.isfinite(s["loss"]) for s in steps):
        raise AssertionError(f"curriculum steps: T {[s['T'] for s in steps]} (want {want_t}), "
                             f"steps with other launch counts: {bad}")
    del engine, loader, it
    torch.cuda.empty_cache()
    return seen


def resume_ladder(initialize, GPT2Model, cfg, dataset, tmp):
    """Two full-width layers, two tags: a truncated file in the newest tag
    makes load restore the older one; an explicit tag that fails
    verification loads nothing; a model with another head count raises
    CheckpointLayoutError."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (CheckpointLayoutError,
                                                                       wait_for_pending_saves)

    c = dataclasses.replace(cfg, n_layer=2, remat=False)
    ckpt = os.path.join(tmp, "ladder")
    engine, _, loader, _ = initialize(model=GPT2Model(c), config=dict(TRAIN_CONFIG),
                                      training_data=dataset)
    it = iter(loader)
    for _ in range(2):
        engine.train_batch(data_iter=it)
        engine.save_checkpoint(ckpt)
    wait_for_pending_saves()
    del engine, loader, it
    victim = os.path.join(ckpt, "global_step2", "state", "params.pt")
    os.truncate(victim, os.path.getsize(victim) // 2)
    fresh, *_ = initialize(model=GPT2Model(c), config={**TRAIN_CONFIG, "seed": SEED + 3},
                           training_data=dataset)
    path, _ = fresh.load_checkpoint(ckpt)
    restored = (os.path.basename(path or ""), fresh.global_steps)
    explicit = fresh.load_checkpoint(ckpt, tag="global_step2")
    other, *_ = initialize(model=GPT2Model(dataclasses.replace(c, n_head=12)),
                           config=dict(TRAIN_CONFIG))
    try:
        other.load_checkpoint(ckpt)
        layout_error = None
    except CheckpointLayoutError as e:
        layout_error = str(e)[:160]
    emit(f"resume {TRAIN_MODEL} 2-layer ladder", truncated="global_step2/state/params.pt",
         restored=restored, explicit_corrupt_tag=list(explicit), layout_error=layout_error)
    if restored != ("global_step1", 1) or explicit != (None, {}) or layout_error is None:
        raise AssertionError(f"ladder: restored {restored}, explicit {explicit}, "
                             f"layout error {layout_error}")
    del fresh, other
    torch.cuda.empty_cache()


def data_and_checkpoint_slices(initialize, GPT2Model, cfg, accel, fa):
    """The resume, curriculum and ladder phases over one token dataset in a
    temporary directory on the disk with the most room, removed afterwards.
    Where no candidate holds DISK_MARGIN times the tag, depth is cut to the
    most layers that fit."""
    need = lambda n: STATE_BYTES_PER_PARAM * dataclasses.replace(cfg, n_layer=n).num_params()
    root, free = _scratch_dir()
    layers = cfg.n_layer
    while layers > 2 and DISK_MARGIN * need(layers) > free[root]:
        layers -= 1
    tmp = tempfile.mkdtemp(prefix="ds_resume_", dir=root)
    try:
        emit("disk", free_bytes=free, chosen=root, tag_bytes_predicted=need(layers),
             layers=layers, depth_cut=layers != cfg.n_layer, **_disk_rates(tmp))
        dataset = _token_dataset(tmp, cfg.vocab_size)
        c = dataclasses.replace(cfg, n_layer=layers)
        resume = resume_slice(initialize, GPT2Model, c, accel, fa, dataset, tmp)
        curriculum = curriculum_slice(initialize, GPT2Model, cfg, fa, dataset)
        resume_ladder(initialize, GPT2Model, cfg, dataset, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return resume, curriculum


# ------------------------------------------------- offload and ZeRO-Infinity
def _pcie_rates(nbytes: int = 1 << 30) -> dict:
    """What the host link gives without the engine: ``copy_`` of ``nbytes``
    between a pinned host tensor and the card, each way, in GB/s of device
    time (CUDA events, the mean of three copies after one)."""
    from deepspeed_tpu_torch.ops.aio import host_zeros

    host = host_zeros(nbytes, torch.uint8, pin=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    out = {"probe_bytes": nbytes}
    for name, dst, src in (("h2d", dev, host), ("d2h", host, dev)):
        dst.copy_(src, non_blocking=True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        out[f"pinned_{name}_gb_per_s"] = 3 * nbytes / (start.elapsed_time(end) / 1e3) / 1e9
    del host, dev
    return out


def _offload_engine(initialize, GPT2Model, c, zero, knobs=(), config=None):
    """An engine of ``c`` through ``initialize``, its weights drawn from the
    config's seed straight into their placement, the offload knobs set only
    while it is built; and its init seconds and the card's peak during
    init."""
    for k in OFFLOAD_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(dict(knobs))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine, *_ = initialize(model=GPT2Model(c), config={**(config or OFFLOAD_CONFIG),
                                                            "zero_optimization": zero})
        torch.cuda.synchronize()
        init = {"init_s": time.perf_counter() - t0,
                "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    finally:
        for k in OFFLOAD_KNOBS:
            os.environ.pop(k, None)
    return engine, init


def _host_state_bytes(engine) -> int:
    """The bytes of the engine's state in host memory, every tensor of it
    held to be pinned."""
    z = engine._zero
    host = [t for v in engine.opt_state._asdict().values() if isinstance(v, list) for t in v]
    host += [t for t in z.fp32 if t is not None] + list(z.parts.values())
    host = [t for t in host if t.device.type == "cpu"]
    if not all(t.is_pinned() for t in host):
        raise AssertionError("offloaded host state that is not pinned")
    return sum(t.numel() * t.element_size() for t in host)


def _dense_launches(fa) -> dict:
    return {"flash_attention_fwd": fa.KERNEL.launches, **fa.BWD_KERNEL.entry_launches}


def _check_remat_launches(fa, layers: int, steps: int, label: str) -> dict:
    """Each step under remat launches the forward kernel twice per layer (the
    forward and its recompute) and each backward kernel once."""
    launches = _dense_launches(fa)
    expect = {"flash_attention_fwd": 2 * layers * steps,
              **dict.fromkeys(fa.BWD_KERNEL.entry_launches, layers * steps)}
    if launches != expect:
        raise AssertionError(f"{label}: launch counts {launches} over {steps} steps, "
                             f"expected {expect}")
    return launches


def _offload_row(engine, c, batch, step_ms, prof, accel) -> dict:
    """A training line with the host link's bytes and rates: bytes of the
    last update each way, their GB/s over the profiled step's copy time,
    and the step split into copy and compute device time."""
    off = engine._offload
    h2d, d2h = (off.h2d_bytes, off.d2h_bytes) if off is not None else (0, 0)
    copy = prof["memcpy_ms"]
    compute_ms = prof["device_ms"] - copy["HtoD"] - copy["DtoH"]
    return dict(_train_line(c, OFFLOAD_BATCH, OFFLOAD_SEQ, step_ms, accel), remat=c.remat,
                layers=c.n_layer, h2d_gb_per_step=h2d / 1e9, d2h_gb_per_step=d2h / 1e9,
                h2d_gb_per_s=h2d / max(copy["HtoD"], 1e-9) / 1e6,
                d2h_gb_per_s=d2h / max(copy["DtoH"], 1e-9) / 1e6,
                profiled_step={"wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
                               "compute_ms": compute_ms, "memcpy_ms": copy,
                               "idle_share": prof["idle_share"],
                               "by_category": prof["by_category"]})


def offload_slice(initialize, GPT2Model, cfg, accel, fa):
    """gpt2-2.7b, full preset, 4 x 2048, through initialize → train_batch:
    (a) no offload, (b) ``offload_optimizer: cpu`` under the auto policy
    (the master stays on the card, the moments stream in whole),
    (b_streamed) the same placement through the streamed update, (c) the
    master on the host, streamed unit by unit, serially, (d) as (c) with
    ``stream_overlap``. Each offloaded run must give (a)'s losses and
    params bit for bit; each run's steps, peaks, host state, host-link bytes and rates and
    a profiled step are reported beside a pinned ``copy_``'s rates."""
    import gc

    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    c = cfg
    batch = synthetic_lm_batch(OFFLOAD_BATCH, OFFLOAD_SEQ, c.vocab_size, seed=SEED,
                               device="cuda")
    pcie = _pcie_rates()
    emit("host link", **pcie)
    cpu, host = {"device": "cpu"}, {"DS_TPU_OFFLOAD_MASTER": "host",
                                     "DS_TPU_FORCE_STREAMED_OFFLOAD": "1"}
    variants = (("a", {"stage": 1}, {}, None),
                ("b", {"stage": 1, "offload_optimizer": cpu}, {}, (False, False, False)),
                # (b)'s placement through the streamed update: what the whole
                # stream-in gains for Adam
                ("b_streamed", {"stage": 1, "offload_optimizer": cpu},
                 {"DS_TPU_OFFLOAD_MASTER": "hbm", "DS_TPU_FORCE_STREAMED_OFFLOAD": "1"},
                 (False, True, False)),
                ("c", {"stage": 1, "offload_optimizer": cpu}, host, (True, True, False)),
                ("d", {"stage": 1, "offload_optimizer": {**cpu, "stream_overlap": True}}, host,
                 (True, True, True)))
    ref, launches = None, {}
    for name, zero, knobs, policy in variants:
        engine, init = _offload_engine(initialize, GPT2Model, c, zero, knobs)
        off = engine._offload
        got = None if off is None else (off.master_host, off.streamed, off.overlap)
        if got != policy:
            raise AssertionError(f"offload ({name}): policy (master on host, streamed, "
                                 f"overlap) {got}, expected {policy}")
        host_gb = _host_state_bytes(engine) / 1e9
        losses, step_ms, peak_gb = _timed_steps(engine, batch, accel, (fa.KERNEL, fa.BWD_KERNEL))
        launches[name] = _check_remat_launches(fa, c.n_layer, TRAIN_STEPS, f"offload ({name})")
        params = {k: v.cpu() for k, v in engine.module_state_dict().items()}
        prof = device_profile(lambda: engine.train_batch(batch), top=8)
        if ref is None:
            ref, same = (losses, params), None
        else:
            differ = sorted(k for k in params if not _bitwise_equal(params[k], ref[1][k]))
            same = losses == ref[0] and not differ
        row = dict(zero=zero, knobs=dict(knobs),
                   policy=dict(zip(("master_on_host", "streamed", "stream_overlap"), got or ())),
                   **_offload_row(engine, c, batch, step_ms, prof, accel), **init,
                   peak_mem_gb=peak_gb, host_state_gb=host_gb, losses=losses,
                   bitwise_equal_to_a=same, launches=launches[name])
        del engine, params, off
        gc.collect()
        torch.cuda.empty_cache()
        emit(f"offload {OFFLOAD_MODEL} ({name})", **row, host_memory_after=_host_memory())
        if same is False:
            raise AssertionError(f"offload ({name}) differs from (a): losses {losses} vs "
                                 f"{ref[0]}, {len(differ)} params differ ({differ[:4]})")
    return launches


def _meminfo(path: str = "/proc/meminfo") -> dict:
    """A /proc file of ``key: value kB`` lines in bytes (/proc/meminfo:
    what ``free`` reads; /proc/self/status: this process's memory)."""
    out = {}
    with open(path) as f:
        for line in f:
            key, _, value = line.partition(":")
            parts = value.split()
            if len(parts) == 2 and parts[1] == "kB":
                out[key] = int(parts[0]) * 1024
    return out


def _host_memory() -> dict:
    """The host's available memory and this process's resident and pinned
    memory, in GB."""
    mine = _meminfo("/proc/self/status")
    return {"available_gb": _meminfo()["MemAvailable"] / 1e9,
            "process_rss_gb": mine.get("VmRSS", 0) / 1e9,
            "process_pinned_gb": mine.get("VmPin", 0) / 1e9,
            "process_locked_gb": mine.get("VmLck", 0) / 1e9}


def _settle_host_memory(timeout_s: float = 60.0) -> float:
    """Wait until the host's available memory stops rising (the kernel
    counts freed pinned pages as available again some seconds after the
    free); the seconds waited."""
    t0 = time.perf_counter()
    seen = [_meminfo()["MemAvailable"]]
    while time.perf_counter() - t0 < timeout_s:
        time.sleep(1.0)
        seen.append(_meminfo()["MemAvailable"])
        if len(seen) > 3 and seen[-1] - seen[-4] < 5e8:
            break
    return time.perf_counter() - t0


def capacity_slice(initialize, GPT2Model, cfg, accel, fa):
    """gpt2-6.7b at full width, 4 x 2048, ``offload_optimizer: cpu`` under
    the auto policy (the master on the host, the update streamed unit by
    unit), built through zero.Init's path: trains with a finite, falling
    loss through K1/K2. The depth is the preset's, or, when the host cannot
    hold its fp32 master and moments beside the process, the most layers
    that fit and never fewer than MIN_CAPACITY_LAYERS (set from
    /proc/meminfo here and printed)."""
    import gc

    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    gc.collect()
    waited = _settle_host_memory()
    mem = _meminfo()
    params = lambda n: dataclasses.replace(cfg, n_layer=n).num_params()
    layers = cfg.n_layer
    while layers >= MIN_CAPACITY_LAYERS and \
            HOST_BYTES_PER_PARAM * params(layers) + HOST_MARGIN > mem["MemAvailable"]:
        layers -= 1
    emit("host memory", mem_total_gb=mem["MemTotal"] / 1e9, settle_s=waited,
         mem_available_gb=mem["MemAvailable"] / 1e9, margin_gb=HOST_MARGIN / 1e9,
         model=CAPACITY_MODEL, layers=layers, depth_cut=layers != cfg.n_layer,
         host_state_gb_needed=HOST_BYTES_PER_PARAM * params(layers) / 1e9,
         card_state_gb_without_offload=18 * params(layers) / 1e9)
    if layers < MIN_CAPACITY_LAYERS:
        raise AssertionError(f"host memory {mem['MemAvailable'] / 1e9:.1f} GB available holds "
                             f"fewer than {MIN_CAPACITY_LAYERS} layers of {CAPACITY_MODEL}")
    c = dataclasses.replace(cfg, n_layer=layers)
    batch = synthetic_lm_batch(OFFLOAD_BATCH, OFFLOAD_SEQ, c.vocab_size, seed=SEED,
                               device="cuda")
    engine, init = _offload_engine(initialize, GPT2Model, c,
                                   {"stage": 1, "offload_optimizer": {"device": "cpu"}})
    off = engine._offload
    if not (off.master_host and off.streamed and not off.overlap):
        raise AssertionError(f"{CAPACITY_MODEL}: the auto policy did not put the master on "
                             f"the host and stream the update: {vars(off)}")
    host_gb = _host_state_bytes(engine) / 1e9
    losses, step_ms, peak_gb = _timed_steps(engine, batch, accel, (fa.KERNEL, fa.BWD_KERNEL))
    launches = _check_remat_launches(fa, c.n_layer, TRAIN_STEPS, f"offload {CAPACITY_MODEL}")
    prof = device_profile(lambda: engine.train_batch(batch), top=8)
    emit(f"offload {CAPACITY_MODEL}", **_offload_row(engine, c, batch, step_ms, prof, accel),
         **init, peak_mem_gb=peak_gb, host_state_gb=host_gb, losses=losses,
         launches=launches, params_on_card_gb=2 * c.num_params() / 1e9)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _nvme_swapper(engine):
    opt = getattr(engine, "_nvme_optimizer", None) or engine.optimizer
    return opt.swapper


def nvme_slice(initialize, GPT2Model, cfg, accel, fa, tmp):
    """gpt2-2.7b's width at NVME_LAYERS layers, 4 x 2048, bf16: (e)
    ``offload_optimizer: nvme`` through the engine and (f) ``offload_param:
    nvme`` (the ZeRO-Infinity engine), each from the same seed as the
    engine without offload, whose losses they must give within
    NVME_LOSS_RTOL; the disk's bytes and rates per step."""
    import gc

    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    c = dataclasses.replace(cfg, n_layer=NVME_LAYERS)
    batch = synthetic_lm_batch(OFFLOAD_BATCH, OFFLOAD_SEQ, c.vocab_size, seed=SEED,
                               device="cuda")
    config = {**OFFLOAD_CONFIG, "aio": dict(NVME_AIO)}
    runs, launches = {}, {}
    for name, zero in (("memory", {"stage": 1}),
                       ("e", {"stage": 1, "offload_optimizer": {
                           "device": "nvme", "nvme_path": os.path.join(tmp, "e")}}),
                       ("f", {"stage": 3, "offload_param": {
                           "device": "nvme", "nvme_path": os.path.join(tmp, "f")}})):
        engine, init = _offload_engine(initialize, GPT2Model, c, zero, config=config)
        losses = [float(engine.train_batch(batch)) for _ in range(NVME_WARMUP)]
        sw = None if name == "memory" else _nvme_swapper(engine)
        before = dict(sw.stats()) if sw else {}
        for kern in (fa.KERNEL, fa.BWD_KERNEL):
            kern.reset_launches()
        step_s = []
        for _ in range(NVME_STEPS):
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            step_s.append(time.perf_counter() - t0)
        launches[name] = _check_remat_launches(fa, c.n_layer, NVME_STEPS, f"nvme ({name})")
        row = {"zero": zero, "layers": c.n_layer, "params": c.num_params(), **init,
               "losses": losses, "step_s_each": step_s, "step_s": sorted(step_s)[len(step_s) // 2],
               "tokens_per_s": OFFLOAD_BATCH * OFFLOAD_SEQ / sorted(step_s)[len(step_s) // 2]}
        if sw:
            after = sw.stats()
            read = (after["swap_in_bytes"] - before["swap_in_bytes"]) / NVME_STEPS
            wrote = (after["swap_out_bytes"] - before["swap_out_bytes"]) / NVME_STEPS
            moved = {k: (after[k] - before[k]) / NVME_STEPS for k in AIO_COUNTS}
            row.update(disk_read_gb_per_step=read / 1e9, disk_write_gb_per_step=wrote / 1e9,
                       disk_gb_per_s=(read + wrote) / row["step_s"] / 1e9,
                       aio_per_step=moved,
                       state_on_disk_gb=(engine._nvme_optimizer if name == "e"
                                         else engine.optimizer).state_bytes() / 1e9)
        runs[name] = row
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        if name != "memory":
            shutil.rmtree(os.path.join(tmp, name), ignore_errors=True)
    ref = runs["memory"]["losses"]
    rel = {n: max(abs(a - b) / abs(b) for a, b in zip(runs[n]["losses"], ref)) for n in "ef"}
    for name, row in runs.items():
        emit(f"nvme {OFFLOAD_MODEL} {NVME_LAYERS}-layer ({name})", **row,
             loss_rel_to_memory=rel.get(name), rtol=NVME_LOSS_RTOL, launches=launches[name])
    if max(rel.values()) > NVME_LOSS_RTOL or not all(
            math.isfinite(x) for r in runs.values() for x in r["losses"]):
        raise AssertionError(f"NVMe runs against the engine in memory: loss rel {rel}")
    # the rates above are the disk's only if no chunk went through the page cache
    buffered = {n: runs[n]["aio_per_step"]["buffered_chunks"] for n in "ef"}
    if any(buffered.values()):
        raise AssertionError(f"NVMe runs: chunks through the page cache per step {buffered}; "
                             "the swap files must be read and written with O_DIRECT")
    return launches


def nvme_check_fp32(initialize, GPT2Model, cfg, tmp):
    """fp32, gpt2-2.7b's width, 2 layers: (e) and (f) against the engine in
    memory from the same seed, losses and params within FP32_NVME_RTOL (the
    params in L2 over all tensors together, as train_check_fp32 holds
    them)."""
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    k = NVME_FP32
    c = dataclasses.replace(cfg, n_layer=k["layers"], remat=False, dtype=torch.float32)
    config = {"train_batch_size": k["batch"], "steps_per_print": 0, "gradient_clipping": 1.0,
              "seed": SEED + 1, "aio": dict(NVME_AIO),
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}}}
    batch = synthetic_lm_batch(k["batch"], k["seq"], c.vocab_size, seed=SEED + 1, device="cuda")
    runs = {}
    for name, zero in (("memory", {"stage": 1}),
                       ("e", {"stage": 1, "offload_optimizer": {
                           "device": "nvme", "nvme_path": os.path.join(tmp, "e32")}}),
                       ("f", {"stage": 3, "offload_param": {
                           "device": "nvme", "nvme_path": os.path.join(tmp, "f32")}})):
        engine, _ = _offload_engine(initialize, GPT2Model, c, zero, config=config)
        losses = [float(engine.train_batch(batch)) for _ in range(k["steps"])]
        if name == "f":
            tree = engine.gather_params()
            params = {n: v for n, v in tree.items() if n != "blocks"}
            params.update({f"blocks.{l}.{key}": v[l] for key, v in tree["blocks"].items()
                           for l in range(c.n_layer)})
        else:
            params = {n: v.cpu() for n, v in engine.module_state_dict().items()}
        runs[name] = (losses, params)
        del engine
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(tmp, f"{name}32"), ignore_errors=True)
    (l0, p0) = runs["memory"]
    flat = lambda ps: torch.cat([ps[n].double().flatten() for n in sorted(p0)])
    out = {}
    for name in "ef":
        ln, pn = runs[name]
        out[name] = {"losses": ln,
                     "loss_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(ln, l0)),
                     "param_rel_l2": _rel_l2(flat(pn), flat(p0))}
    emit(f"nvme check {OFFLOAD_MODEL} fp32 {k['layers']}-layer", **k, losses_memory=l0,
         runs=out, rtol=FP32_NVME_RTOL)
    bad = {n: r for n, r in out.items()
           if r["loss_rel_diff"] > FP32_NVME_RTOL or r["param_rel_l2"] > FP32_NVME_RTOL}
    if bad:
        raise AssertionError(f"fp32 NVMe runs against the engine in memory: {bad}")


def resume_offload(initialize, GPT2Model, cfg, tmp):
    """At the NVMe phase's model: (c) (the master on the host, streamed)
    trains two steps and saves; an engine without offload, the NVMe
    engine (e) and the ZeRO-Infinity engine (f) load the tag, and the state
    each restores must equal the saved state bit for bit."""
    import gc

    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (flatten_state,
                                                                       wait_for_pending_saves)

    c = dataclasses.replace(cfg, n_layer=NVME_LAYERS)
    batch = synthetic_lm_batch(OFFLOAD_BATCH, OFFLOAD_SEQ, c.vocab_size, seed=SEED,
                               device="cuda")
    ckpt = os.path.join(tmp, "ckpt")
    src, _ = _offload_engine(initialize, GPT2Model, c, {"stage": 1, "offload_optimizer": {
        "device": "cpu"}}, {"DS_TPU_OFFLOAD_MASTER": "host", "DS_TPU_FORCE_STREAMED_OFFLOAD": "1"})
    for _ in range(2):
        src.train_batch(batch)
    saved = flatten_state(src)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    src.save_checkpoint(ckpt)
    blocking_s = time.perf_counter() - t0
    wait_for_pending_saves()
    record = dict(src._last_save)
    if "error" in record or "commit_s" not in record:
        raise AssertionError(f"the save did not commit: {record}")
    del src
    gc.collect()
    loads = {}
    for name, zero in (("memory", {"stage": 1}),
                       ("e", {"stage": 1, "offload_optimizer": {
                           "device": "nvme", "nvme_path": os.path.join(tmp, "resume_e")}}),
                       ("f", {"stage": 3, "offload_param": {
                           "device": "nvme", "nvme_path": os.path.join(tmp, "resume_f")}})):
        engine, _ = _offload_engine(initialize, GPT2Model, c, zero,
                                    config={**OFFLOAD_CONFIG, "aio": dict(NVME_AIO)})
        _evict_from_page_cache(record["path"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.load_checkpoint(ckpt)
        load_s = time.perf_counter() - t0
        restored = flatten_state(engine)
        differ = sorted(k for k in saved if k not in restored
                        or not _bitwise_equal(restored[k], saved[k]))
        loads[name] = {"load_s": load_s, "tensors_differing": len(differ)}
        if restored.keys() != saved.keys() or differ:
            raise AssertionError(f"offloaded tag loaded into ({name}): {len(differ)} tensors "
                                 f"differ ({differ[:4]})")
        del engine, restored
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(tmp, f"resume_{name}"), ignore_errors=True)
    emit(f"resume offload {OFFLOAD_MODEL} {NVME_LAYERS}-layer", saved_by="(c)",
         tag_bytes=_tree_bytes(record["path"]), save_blocking_s=blocking_s,
         commit_s=record["commit_s"], loads=loads, state_bitwise_after_load=True)


def offload_slices(initialize, GPT2Model, presets, accel, fa):
    """The offload, capacity, NVMe and offloaded-resume phases; the NVMe
    ones in a temporary directory on the disk with the most room, removed
    afterwards."""
    launches = {"offload": offload_slice(initialize, GPT2Model, presets[OFFLOAD_MODEL], accel,
                                         fa),
                "capacity": capacity_slice(initialize, GPT2Model, presets[CAPACITY_MODEL],
                                           accel, fa)}
    root, free = _scratch_dir()
    tmp = tempfile.mkdtemp(prefix="ds_nvme_", dir=root)
    try:
        emit("disk nvme", free_bytes=free, chosen=root, **_disk_rates(tmp))
        launches["nvme"] = nvme_slice(initialize, GPT2Model, presets[OFFLOAD_MODEL], accel, fa,
                                      tmp)
        nvme_check_fp32(initialize, GPT2Model, presets[OFFLOAD_MODEL], tmp)
        resume_offload(initialize, GPT2Model, presets[OFFLOAD_MODEL], tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.registry import resolve_family
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.pallas import decode_attention as da
    from deepspeed_tpu_torch.ops.pallas import flash_attention as fa

    # fp32 matmuls and convolutions in full fp32 (no TF32) for the references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    cap = torch.cuda.get_device_capability(0)
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(cap), count=torch.cuda.device_count())
    if cap[0] != 9:
        raise AssertionError(f"compute capability {cap}: the kernels are built for sm_90a")
    accel = deepspeed_tpu_torch.get_accelerator()

    all_kernels = (fa.KERNEL, fa.BWD_KERNEL, da.KERNEL, fa.SPARSE_KERNEL)
    build_s = op_builder.build_all(all_kernels)
    emit("build", seconds=build_s,
         ptxas={k.name: ptxas_summary(k.build_log) for k in all_kernels})

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf, f32 = torch.bfloat16, torch.float32
    f16 = torch.float16
    # the 64-row tiles' edges: T = 1, 63, 64, 65, 127, 200, 1000, Tq != Tk, and
    # D 64 / 96 / 128 in bf16 and fp16; the curriculum phase's lengths below 1024
    ragged = sorted(set(curriculum_lengths()) - {TRAIN_SEQ})
    flash_rows = [check_flash(fa, accel, gen, *case) for case in (
        ("train", TRAIN_BATCH, TRAIN_SEQ, 16, 96, bf, True),
        ("slice", BATCH, PROMPT, 32, 64, bf, True),
        ("t1", BATCH, 1, 32, 64, bf, True),
        ("t100_ragged", BATCH, 100, 32, 64, bf, True),
        ("noncausal", BATCH, PROMPT, 32, 64, bf, False),
        ("d96", BATCH, PROMPT, 32, 96, bf, True),
        ("d128", BATCH, PROMPT, 32, 128, bf, True),
        ("fp32", BATCH, PROMPT, 32, 64, f32, True),
        ("fp16", BATCH, PROMPT, 32, 64, f16, True),
        ("fp16_d96", BATCH, PROMPT, 32, 96, f16, True),
        ("fp16_d128", BATCH, PROMPT, 32, 128, f16, True),
        # the head dims of gpt2-tiny (32), gpt2-2.7b (80) and llama-tiny (16)
        ("d16", BATCH, PROMPT, 32, 16, bf, True),
        ("d32", BATCH, PROMPT, 32, 32, bf, True),
        ("d80", BATCH, PROMPT, 32, 80, bf, True),
        ("fp16_d80", BATCH, PROMPT, 32, 80, f16, True),
        ("fp32_d16", BATCH, PROMPT, 32, 16, f32, True),
        ("fp32_d80", BATCH, PROMPT, 32, 80, f32, False),
        *((f"t{t}", 4, t, 16, 96, bf, True) for t in (63, 64, 65, 127, 200, 1000)),
        ("noncausal_tq100_tk300", 4, 100, 16, 96, bf, False, 300),
        ("causal_tq64_tk200", 4, 64, 16, 96, bf, True, 200),
        # the curriculum phase's ragged lengths at the training cell's B, H, D
        *((f"curriculum_t{t}", TRAIN_BATCH, t, 16, 96, bf, True) for t in ragged),
        # the offload phases' shapes: gpt2-2.7b (D=80) and gpt2-6.7b (D=128),
        # 32 heads, at their B x T
        ("offload_d80", OFFLOAD_BATCH, OFFLOAD_SEQ, 32, 80, bf, True),
        ("capacity_d128", OFFLOAD_BATCH, OFFLOAD_SEQ, 32, 128, bf, True),
        # the long serving path's prefill, one row (the plain version's
        # (H, T, T) fp32 scores take 8 GB)
        ("long_prefill", 1, LONG_PROMPT, 32, 64, bf, True))]
    BH = TRAIN_BATCH * 16
    bwd_rows = [check_flash_bwd(fa, accel, gen, *case) for case in (
        ("train", BH, TRAIN_SEQ, 96, bf, True),
        ("d64", BH, TRAIN_SEQ, 64, bf, True),
        ("d128", BH, TRAIN_SEQ, 128, bf, True),
        ("t1000_ragged", BH, 1000, 96, bf, True),
        ("t1", BH, 1, 96, bf, True),
        ("noncausal", BH, TRAIN_SEQ, 96, bf, False),
        ("fp32", BH, TRAIN_SEQ, 96, f32, True),
        ("fp16", BH, TRAIN_SEQ, 96, f16, True),
        ("fp16_d64", BH, TRAIN_SEQ, 64, f16, True),
        ("fp16_d128", BH, TRAIN_SEQ, 128, f16, True),
        ("d16", BH, TRAIN_SEQ, 16, bf, True),
        ("d32", BH, TRAIN_SEQ, 32, bf, True),
        ("d80", BH, TRAIN_SEQ, 80, bf, True),
        ("fp16_d80", BH, TRAIN_SEQ, 80, f16, False),
        ("fp32_d16", 64, 200, 16, f32, True),
        ("fp32_d80", 64, 200, 80, f32, True),
        *((f"t{t}", 64, t, 96, bf, True) for t in (63, 64, 65, 127, 200)),
        ("noncausal_tq100_tk300", 64, 100, 96, bf, False, 300),
        ("causal_tq64_tk200", 64, 64, 96, bf, True, 200),
        *((f"curriculum_t{t}", BH, t, 96, bf, True) for t in ragged),
        ("offload_d80", OFFLOAD_BATCH * 32, OFFLOAD_SEQ, 80, bf, True),
        ("capacity_d128", OFFLOAD_BATCH * 32, OFFLOAD_SEQ, 128, bf, True))]
    S = PROMPT + GEN
    decode_rows = [check_decode(da, accel, gen, *case) for case in (
        ("slice_pos255", BATCH, S, 32, 8, 64, bf, S - 1),
        ("slice_pos0", BATCH, S, 32, 8, 64, bf, 0),
        ("slice_pos127", BATCH, S, 32, 8, 64, bf, 127),
        ("slice_pos128", BATCH, S, 32, 8, 64, bf, 128),
        ("mha", BATCH, S, 32, 32, 64, bf, 200),
        ("mqa", BATCH, S, 32, 1, 64, bf, 200),
        ("d128", BATCH, S, 32, 8, 128, bf, 200),
        ("fp32", BATCH, S, 32, 8, 64, f32, S - 1),
        ("fp16", BATCH, S, 32, 8, 64, f16, S - 1),
        ("d16", BATCH, S, 32, 8, 16, bf, 200),
        ("d32", BATCH, S, 32, 8, 32, bf, 200),
        ("d80", BATCH, S, 32, 32, 80, bf, 200),
        ("fp16_d80", BATCH, S, 32, 32, 80, f16, S - 1),
        ("fp32_d16", BATCH, S, 32, 8, 16, f32, 200),
        ("fp32_d80", BATCH, S, 32, 32, 80, f32, 200))]
    decode_rows.append(check_decode(da, accel, gen, "garbage_past_pos", BATCH, S, 32, 8, 64,
                                    bf, 100, garbage=True))
    # the long caches the split is for, its chunks' edges, and the other types
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    long_chunk = da.decode_chunk(LONG_BATCH, 8, LONG_S, n_sm)
    long_rows = [check_decode(da, accel, gen, *case) for case in (
        ("long_b4_s8192", LONG_BATCH, LONG_S, 32, 8, 64, bf, LONG_S - 1),
        ("long_b1_s32768_pos20000", 1, 32768, 32, 8, 64, bf, 20000),
        ("long_pos_chunk_last", LONG_BATCH, LONG_S, 32, 8, 64, bf, long_chunk - 1),
        ("long_pos_chunk_first", LONG_BATCH, LONG_S, 32, 8, 64, bf, long_chunk),
        ("long_fp32", LONG_BATCH, LONG_S, 32, 8, 64, f32, LONG_S - 1),
        ("long_fp16", LONG_BATCH, LONG_S, 32, 8, 64, f16, LONG_S - 1),
        ("long_mqa", LONG_BATCH, LONG_S, 32, 1, 64, bf, LONG_S - 1))]
    long_rows.append(check_decode(da, accel, gen, "long_garbage_past_pos", LONG_BATCH, LONG_S,
                                  32, 8, 64, bf, 5000, garbage=True))
    from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config
    sparse_rows = [check_sparse(fa, accel, gen, *case)
                   for case in sparse_cases(fa, sparsity_config)]

    model_cls, presets = resolve_family(MODEL)
    serve_launches = serve_slice(deepspeed_tpu_torch.init_inference, model_cls, presets[MODEL],
                                 accel, fa, da)
    serve_small_fp32(deepspeed_tpu_torch.init_inference, model_cls, presets[MODEL])
    serve_small_fp16(deepspeed_tpu_torch.init_inference, model_cls, presets[MODEL], fa, da)
    serve_sampled(deepspeed_tpu_torch.init_inference, model_cls, presets[MODEL], da)
    serve_long(deepspeed_tpu_torch.init_inference, model_cls, presets[MODEL], fa, da)

    gpt2_cls, gpt2_presets = resolve_family(TRAIN_MODEL)
    train_launches, batch = train_slice(deepspeed_tpu_torch.initialize, gpt2_cls,
                                        gpt2_presets[TRAIN_MODEL], accel, fa)
    train_check_bf16(gpt2_cls, dataclasses.replace(gpt2_presets[TRAIN_MODEL], remat=False),
                     batch, TRAIN_MODEL, _dense_plain)
    train_check_fp32(deepspeed_tpu_torch.initialize, gpt2_cls, gpt2_presets[TRAIN_MODEL],
                     TRAIN_MODEL, TRAIN_SEQ, {}, _dense_plain)
    zero_launches = zero_slice(deepspeed_tpu_torch.initialize, gpt2_cls,
                               gpt2_presets[TRAIN_MODEL], accel, fa)

    sparse_cfg = gpt2_presets[SPARSE_MODEL]
    sparse_launches, batch = train_sparse_slice(deepspeed_tpu_torch.initialize, gpt2_cls,
                                                sparse_cfg, accel, fa)
    sparse_plain = lambda m: _sparse_plain(fa, m, SPARSE_BLOCK, SPARSE_SEQ)
    # remat "full" on both paths: the plain path's (B*H, T, T) fp32 scores
    # would not fit next to the model for 24 layers at once
    train_check_bf16(gpt2_cls, dataclasses.replace(sparse_cfg, sparse_attention=SPARSE_BLOCK,
                                                   remat="full"),
                     batch, f"{SPARSE_MODEL} sparse-fixed16", sparse_plain)
    train_check_fp32(deepspeed_tpu_torch.initialize, gpt2_cls, sparse_cfg,
                     f"{SPARSE_MODEL} sparse-fixed16", SPARSE_SEQ,
                     {"sparse_attention": dict(SPARSE_BLOCK)}, sparse_plain)
    check_head_dim_80(deepspeed_tpu_torch.initialize, gpt2_cls, gpt2_presets["gpt2-2.7b"], fa)
    resume_launches, curriculum_launches = data_and_checkpoint_slices(
        deepspeed_tpu_torch.initialize, gpt2_cls, gpt2_presets[TRAIN_MODEL], accel, fa)
    offload_launches = offload_slices(deepspeed_tpu_torch.initialize, gpt2_cls, gpt2_presets,
                                      accel, fa)
    # launches per offload path: the five gpt2-2.7b runs, gpt2-6.7b, the NVMe runs
    by_offload = {f"offload_{k}": v for k, v in offload_launches["offload"].items()}
    by_offload["offload_capacity"] = offload_launches["capacity"]
    by_offload.update({f"nvme_{k}": v for k, v in offload_launches["nvme"].items()})

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    bwd = bwd_rows[0]
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:123",
         "launches": train_launches["flash_attention_fwd"],
         **{k: flash_rows[0][k] for k in keys},
         "launches_by_path": {"serve": serve_launches["flash_attention_fwd"],
                              "train": train_launches["flash_attention_fwd"],
                              "resume": resume_launches["flash_attention_fwd"],
                              "curriculum": curriculum_launches["flash_attention_fwd"],
                              **{f"zero{s}": n["flash_attention_fwd"]
                                 for s, n in zero_launches.items()},
                              **{p: n["flash_attention_fwd"] for p, n in by_offload.items()}},
         "at_serving_shape": {k: flash_rows[1][k] for k in keys}},
        {"name": "decode_attention", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
         "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:47",
         "launches": serve_launches["decode_attention"],
         **{k: decode_rows[0][k] for k in keys},
         "at_long_shape": {k: long_rows[0][k] for k in keys}},
    ]
    for entry, replaces in (("dq", "deepspeed_tpu/ops/pallas/flash_attention.py:287"),
                            ("dkv", "deepspeed_tpu/ops/pallas/flash_attention.py:313")):
        kernels.append({
            "name": f"flash_attention_bwd_{entry}", "route": "cuda",
            "source": "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu", "replaces": replaces,
            "launches": train_launches[f"flash_attention_bwd_{entry}"],
            "launches_by_path": {p: n[f"flash_attention_bwd_{entry}"] for p, n in (
                ("train", train_launches), ("resume", resume_launches),
                ("curriculum", curriculum_launches),
                *((f"zero{s}", z) for s, z in zero_launches.items()),
                *by_offload.items())},
            "max_abs_err": max(bwd["errs"][n] for n in (("dq",) if entry == "dq"
                                                        else ("dk", "dv"))),
            "ms": bwd[f"{entry}_ms"], "plain_ms": bwd[f"{entry}_plain_ms"],
            "bound_ms": bwd[f"{entry}_bound_ms"], "bound_by": bwd[f"{entry}_bound_by"],
            # no single library call computes one of the pair alone; the
            # pair's yardstick (SDPA backward) is in the kernel phase line
            "library_ms": None})
    sp = sparse_rows[0]
    for entry, replaces, err in (
            ("fwd", "deepspeed_tpu/ops/pallas/flash_attention.py:614", sp["max_abs_err"]),
            ("dq", "deepspeed_tpu/ops/pallas/flash_attention.py:640", sp["grad_errs"]["dq"]),
            ("dkv", "deepspeed_tpu/ops/pallas/flash_attention.py:664",
             max(sp["grad_errs"]["dk"], sp["grad_errs"]["dv"]))):
        name = f"sparse_attention_{'fwd' if entry == 'fwd' else 'bwd_' + entry}"
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deepspeed_tpu_torch/csrc/sparse_attention.cu", "replaces": replaces,
            "launches": sparse_launches[name], "max_abs_err": err,
            "ms": sp[f"{entry}_ms"], "plain_ms": sp[f"{entry}_plain_ms"],
            "bound_ms": sp[f"{entry}_bound_ms"], "bound_by": sp[f"{entry}_bound_by"],
            # SDPA under the layout's token mask computes the forward; no
            # single call computes dq or dk/dv alone (its backward is in the
            # kernel phase line)
            "library_ms": sp["fwd_library_ms"] if entry == "fwd" else None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
