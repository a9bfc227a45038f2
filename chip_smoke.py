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
agrees with the plain path. Each phase prints one JSON
line; any failed check raises, and the script exits non-zero without the
final line. It needs one card and imports nothing of JAX or of the JAX
package.

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
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
ITERS = 20
L2_BYTES = 50 * 2**20
MODEL = "llama3.2-1b"
BATCH, PROMPT, GEN = 32, 128, 128          # the serving cell
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
SPARSE_MODEL = "gpt2-1.3b"
SPARSE_BATCH, SPARSE_SEQ = 4, 2048          # the sparse training cell: micro batch 4, gas 1
# the reference's documented "fixed" layout (DeepSpeed docs, config-json
# "Sparse Attention"), unidirectional as a GPT model uses it
SPARSE_BLOCK = {"mode": "fixed", "block": 16, "different_layout_per_head": True,
                "num_local_blocks": 4, "num_global_blocks": 1, "attention": "unidirectional",
                "horizontal_global_attention": False, "num_different_global_patterns": 4}

# tolerances, with their reasons
# kernel vs plain fp32 on the same inputs: a bf16 or fp16 output carries its
# own rounding (2^-9 or 2^-11 relative, |o| < ~5 for unit-normal v); fp32
# outputs and the fp32 LSE differ only in summation order
TOL = {torch.bfloat16: {"o": 2e-2, "lse": 1e-3}, torch.float16: {"o": 2e-2, "lse": 1e-3},
       torch.float32: {"o": 1e-4, "lse": 1e-4}}
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


def ptxas_summary(log: str) -> dict:
    """Most registers and total spill-store bytes over the kernel's
    template instances, from nvcc's -Xptxas -v report, and for each
    tensor-core instance (``*_mma_kernel<type, D>``) its registers and
    spill-store bytes."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
    mma, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = re.search(r"\d((?:flash|sparse)_[a-z_]*?_mma_kernel)I(\w*?)Li(\d+)E",
                          entry.group(1))
            name = f"{m.group(1)}<{_PTX_TYPES.get(m.group(2), m.group(2))},{m.group(3)}>" \
                if m else None
            if name:
                mma[name] = {"registers": 0, "spill_store_bytes": 0}
        elif name and (sp := re.search(r"(\d+) bytes spill stores", line)):
            mma[name]["spill_store_bytes"] = int(sp.group(1))
        elif name and (rg := re.search(r"Used (\d+) registers", line)):
            mma[name]["registers"] = int(rg.group(1))
    out = {"instances": len(regs), "max_registers": max(regs, default=0),
           "spill_store_bytes": sum(spills)}
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
    import torch.nn.functional as F

    n_valid = min(pos + 1, S)
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
    if garbage:   # entries past pos must not change the output
        k, v = k.clone(), v.clone()
        k[:, pos + 1:] = 1e9
        k[:, pos + 1::2] = -1e9
        v[:, pos + 1:] = float("nan")
    out = da.decode_attention(q, k, v, pos_t)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    if not err <= TOL[dtype]["o"] or not torch.isfinite(out).all():
        raise AssertionError(f"decode_attention {name}: err {err} over {TOL[dtype]['o']}")
    nbytes = (2 * B * n_valid * KV * Dh + 2 * B * H * Dh) * item
    ops = 4.0 * B * H * n_valid * Dh
    b_ms, b_by = bound_ms(accel, nbytes, ops, dtype)
    sdpa = lambda q, k, v, p: F.scaled_dot_product_attention(
        q.view(B, H, 1, Dh), k[:, :n_valid].transpose(1, 2), v[:, :n_valid].transpose(1, 2),
        scale=1.0 / math.sqrt(Dh), enable_gqa=True)
    row = {"name": name, "shape": [B, S, H, KV, Dh], "pos": pos, "dtype": str(dtype),
           "max_abs_err": err, "tol": TOL[dtype]["o"],
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
    T, Tk = Tk or T), the dk/dv kernel twice on the same inputs (the bits
    must repeat; under causal, keys no query sees must get dk = dv = 0
    exactly), then their times beside the bound, the plain versions and
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
    repeat = torch.equal(dk, dk2) and torch.equal(dv, dv2)
    unseen = int(torch.count_nonzero(dk[:, T:]).item() + torch.count_nonzero(dv[:, T:]).item()) \
        if causal and Tk > T else 0
    if not repeat or unseen:
        raise AssertionError(f"flash_attention_bwd_dkv {name}: bitwise repeat {repeat}, "
                             f"{unseen} nonzero dk/dv entries of keys no query sees")
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
           "rtol": tol, "dkv_bitwise_repeat": repeat, "unseen_key_nonzero": unseen,
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
    shape and layout, the backward pair twice on the same inputs (the bits
    must repeat), then their times beside the bound, the plain versions and
    scaled_dot_product_attention under the layout's token mask, with the
    backward schedules' useful shares. An unattended key block must get
    dk = dv = 0 exactly; a dense layout must give the dense flash kernel's
    output."""
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
    if not (err_o <= tol["o"] and err_lse <= tol["lse"]) or not torch.isfinite(o).all():
        raise AssertionError(f"sparse_attention_fwd {name}: o err {err_o}, lse err {err_lse} "
                             f"over {tol}")
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
           "grad_ref_max_abs": scales, "grad_rtol": gtol, "bwd_bitwise_repeat": repeat}
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
def serve_slice(init_inference, LlamaModel, cfg, accel, fa, da):
    """llama3.2-1b, bf16, full width and depth: the counted main-path run."""
    c = dataclasses.replace(cfg, use_flash_decode=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = LlamaModel(c).init_params(gen)
    engine = init_inference(model, {"dtype": "bfloat16", "max_out_tokens": PROMPT + GEN})
    ids = torch.randint(0, c.vocab_size, (BATCH, PROMPT), generator=gen, device="cuda")

    engine.generate(ids[:2, :8], max_new_tokens=2)   # warm-up (library handles)
    torch.cuda.synchronize()
    accel.reset_peak_memory_stats()
    fa.KERNEL.reset_launches()
    da.KERNEL.reset_launches()
    t0 = time.perf_counter()
    out = engine.generate(ids, max_new_tokens=GEN)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.KERNEL.launches,
                "decode_attention": da.KERNEL.launches}
    peak_gb = accel.max_memory_allocated() / 1e9

    expect = {"flash_attention_fwd": c.n_layer, "decode_attention": c.n_layer * GEN}
    if launches != expect:
        raise AssertionError(f"launch counts {launches}, expected {expect}")
    if tuple(out.shape) != (BATCH, PROMPT + GEN) or not torch.equal(out[:, :PROMPT], ids) \
            or out.min().item() < 0 or out.max().item() >= c.vocab_size:
        raise AssertionError(f"generate output malformed: {tuple(out.shape)}")

    # the same weights through the plain versions, selected by the model's own
    # flags (use_flash_attention / use_flash_decode off), not as a fallback
    plain = LlamaModel(dataclasses.replace(c, use_flash_attention=False, use_flash_decode=False))
    plain.load_state_dict(model.state_dict(), assign=True)
    with torch.inference_mode():
        prefill_ms = []
        for _ in range(3):
            cache = model.init_cache(BATCH, PROMPT + GEN)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.prefill(ids, cache)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
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
    prefill_med = sorted(prefill_ms)[1]
    decode_s = gen_s - prefill_med / 1e3
    emit(f"slice {MODEL}", batch=BATCH, prompt=PROMPT, gen=GEN, dtype="bfloat16",
         launches=launches, generate_s=gen_s, prefill_ms=prefill_med,
         decode_tok_s=BATCH * GEN / decode_s, decode_ms_per_step=decode_s * 1e3 / GEN,
         peak_mem_gb=peak_gb, prefill_logits_max_abs_err=err_prefill,
         decode_logits_max_abs_err=err_step, ref_logits_max_abs=scale,
         logit_rtol=LOGIT_RTOL,
         top1_agree=(logits.argmax(-1) == ref.argmax(-1)).float().mean().item())
    with torch.inference_mode():
        profile_slice(model, ids, step_k, cache)
    del engine, model, plain, cache, ref_cache
    torch.cuda.empty_cache()
    return launches


def kernel_category(name: str) -> str:
    """Coarse owner of a device kernel, by its name."""
    if re.search(r"flash_fwd_|flash_bwd_|decode_kernel|sparse_fwd_|sparse_bwd_", name):
        return "port attention kernels"
    if re.search(r"gemm|nvjet|cutlass|xmma|cublas|splitK", name, re.I):
        return "matmul (cuBLAS)"
    if "at::native" in name or "Memcpy" in name or "Memset" in name:
        return "torch elementwise, reduction, copy"
    return "other"


def device_profile(fn, top: int = 6):
    """Run fn() under torch.profiler: host wall ms, device ms summed over
    kernels, the device's idle share of the wall time, device ms by kernel
    category, the top kernels and the number of host-to-device copies. The
    profiler's own overhead lengthens the wall time."""
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
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": max(0.0, 1 - device_ms / wall_ms), "by_category": by_category,
            "top": [[e.key[:70], dev(e), e.count] for e in rows[:top]], "htod_copies": htod}


def profile_slice(model, ids, logits, cache):
    """Where the time goes: one prefill and PROFILE_STEPS decode steps."""
    tok = torch.argmax(logits, dim=-1)

    def decode():
        nonlocal tok
        state = cache
        for _ in range(PROFILE_STEPS):
            step_logits, state = model.decode_step(tok, state)
            tok = torch.argmax(step_logits, dim=-1)

    prefill = device_profile(lambda: model.prefill(ids, model.init_cache(BATCH, PROMPT + GEN)))
    emit(f"profile {MODEL}", prefill=prefill, decode_steps=PROFILE_STEPS,
         decode=device_profile(decode))


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
    # D 64 / 96 / 128 in bf16 and fp16
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
        *((f"t{t}", 4, t, 16, 96, bf, True) for t in (63, 64, 65, 127, 200, 1000)),
        ("noncausal_tq100_tk300", 4, 100, 16, 96, bf, False, 300),
        ("causal_tq64_tk200", 4, 64, 16, 96, bf, True, 200))]
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
        *((f"t{t}", 64, t, 96, bf, True) for t in (63, 64, 65, 127, 200)),
        ("noncausal_tq100_tk300", 64, 100, 96, bf, False, 300),
        ("causal_tq64_tk200", 64, 64, 96, bf, True, 200))]
    S = PROMPT + GEN
    decode_rows = [check_decode(da, accel, gen, *case) for case in (
        ("slice_pos255", BATCH, S, 32, 8, 64, bf, S - 1),
        ("slice_pos0", BATCH, S, 32, 8, 64, bf, 0),
        ("slice_pos127", BATCH, S, 32, 8, 64, bf, 127),
        ("slice_pos128", BATCH, S, 32, 8, 64, bf, 128),
        ("mha", BATCH, S, 32, 32, 64, bf, 200),
        ("mqa", BATCH, S, 32, 1, 64, bf, 200),
        ("d128", BATCH, S, 32, 8, 128, bf, 200),
        ("fp32", BATCH, S, 32, 8, 64, f32, S - 1))]
    decode_rows.append(check_decode(da, accel, gen, "garbage_past_pos", BATCH, S, 32, 8, 64,
                                    bf, 100, garbage=True))
    from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config
    sparse_rows = [check_sparse(fa, accel, gen, *case)
                   for case in sparse_cases(fa, sparsity_config)]

    model_cls, presets = resolve_family(MODEL)
    serve_launches = serve_slice(deepspeed_tpu_torch.init_inference, model_cls, presets[MODEL],
                                 accel, fa, da)
    serve_small_fp32(deepspeed_tpu_torch.init_inference, model_cls, presets[MODEL])

    gpt2_cls, gpt2_presets = resolve_family(TRAIN_MODEL)
    train_launches, batch = train_slice(deepspeed_tpu_torch.initialize, gpt2_cls,
                                        gpt2_presets[TRAIN_MODEL], accel, fa)
    train_check_bf16(gpt2_cls, dataclasses.replace(gpt2_presets[TRAIN_MODEL], remat=False),
                     batch, TRAIN_MODEL, _dense_plain)
    train_check_fp32(deepspeed_tpu_torch.initialize, gpt2_cls, gpt2_presets[TRAIN_MODEL],
                     TRAIN_MODEL, TRAIN_SEQ, {}, _dense_plain)

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

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    bwd = bwd_rows[0]
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:123",
         "launches": train_launches["flash_attention_fwd"],
         **{k: flash_rows[0][k] for k in keys},
         "launches_by_path": {"serve": serve_launches["flash_attention_fwd"],
                              "train": train_launches["flash_attention_fwd"]},
         "at_serving_shape": {k: flash_rows[1][k] for k in keys}},
        {"name": "decode_attention", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
         "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:47",
         "launches": serve_launches["decode_attention"],
         **{k: decode_rows[0][k] for k in keys}},
    ]
    for entry, replaces in (("dq", "deepspeed_tpu/ops/pallas/flash_attention.py:287"),
                            ("dkv", "deepspeed_tpu/ops/pallas/flash_attention.py:313")):
        kernels.append({
            "name": f"flash_attention_bwd_{entry}", "route": "cuda",
            "source": "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu", "replaces": replaces,
            "launches": train_launches[f"flash_attention_bwd_{entry}"],
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
