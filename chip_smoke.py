#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deepspeed_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a Hopper GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``deepspeed_tpu_torch/csrc/``, holds
each kernel against its plain PyTorch version at the serving shapes and at
edge shapes, then serves llama3.2-1b at full width and depth with random
weights through ``init_inference`` → ``generate`` and checks that the run
went through the kernels. Each phase prints one JSON line; any failed check
raises, and the script exits non-zero without the final line. It needs one
card and imports nothing of JAX or of the JAX package.

The last lines are: the kernels' summary as ``{"kernels": [...]}``, the
card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Timing: each time is CUDA-event device time per call, averaged over
``ITERS`` back-to-back calls queued behind a device sleep (so host launch
overhead does not show), with inputs rotated over copies totalling more than
the 50 MB L2 cache, as the model's per-layer calls find them cold.
``bound_ms`` is max(bytes moved / memory bandwidth, operations / peak rate
for the input type), from the accelerator's published peaks.
"""

import dataclasses
import json
import math
import re
import subprocess
import sys
import time

import torch

SEED = 0
ITERS = 20
L2_BYTES = 50 * 2**20
MODEL = "llama3.2-1b"
BATCH, PROMPT, GEN = 32, 128, 128          # the serving cell
SMALL_LAYERS, SMALL_BATCH, SMALL_PROMPT, SMALL_GEN = 2, 4, 32, 16
PROFILE_STEPS = 4

# tolerances, with their reasons
# kernel vs plain fp32 on the same inputs: a bf16 output carries its own
# rounding (2^-9 relative, |o| < ~5 for unit-normal v); fp32 outputs and the
# fp32 LSE differ only in summation order
TOL = {torch.bfloat16: {"o": 2e-2, "lse": 1e-3}, torch.float32: {"o": 1e-4, "lse": 1e-4}}
# llama3.2-1b bf16 logits, kernel path vs plain path on the same weights: the
# plain path rounds scores and probabilities to bf16, the kernels keep them in
# fp32, and 16 layers carry the difference to the logits
LOGIT_RTOL = 5e-2


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


def ptxas_summary(log: str) -> dict:
    """Most registers and total spill-store bytes over the kernel's
    template instances, from nvcc's -Xptxas -v report."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
    return {"instances": len(regs), "max_registers": max(regs, default=0),
            "spill_store_bytes": sum(spills)}


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# ------------------------------------------------------------------ kernels
def check_flash(fa, accel, gen, name, B, T, H, D, dtype, causal):
    import torch.nn.functional as F

    scale = 1.0 / math.sqrt(D)
    per_set = 4 * B * H * T * D * torch.tensor([], dtype=dtype).element_size()
    sets = []
    for _ in range(n_copies(per_set)):
        q, k, v = (torch.randn(B * H, T, D, generator=gen, device="cuda") for _ in range(3))
        sets.append(((q * scale).to(dtype), k.to(dtype), v.to(dtype)))
    q, k, v = sets[0]
    o, lse = fa.flash_forward(q, k, v, causal)
    o_ref, lse_ref = fa.mha_reference_lse(q.float(), k.float(), v.float(), causal)
    torch.cuda.synchronize()
    err_o, err_lse = max_err(o, o_ref), max_err(lse, lse_ref)
    tol = TOL[dtype]
    if not (err_o <= tol["o"] and err_lse <= tol["lse"]) or not torch.isfinite(o).all():
        raise AssertionError(f"flash_attention_fwd {name}: o err {err_o}, lse err {err_lse} "
                             f"over {tol}")
    pairs = sum(min(i + 1, T) for i in range(T)) if causal else T * T
    nbytes = per_set + B * H * T * 4
    b_ms, b_by = bound_ms(accel, nbytes, 4.0 * D * pairs * B * H, dtype)
    sdpa = lambda q, k, v: F.scaled_dot_product_attention(
        q.view(B, H, T, D), k.view(B, H, T, D), v.view(B, H, T, D),
        is_causal=causal, scale=1.0)
    row = {"name": name, "shape": [B, T, H, D], "dtype": str(dtype), "causal": causal,
           "max_abs_err": err_o, "lse_max_abs_err": err_lse, "tol": tol,
           "ms": time_ms(lambda q, k, v: fa.flash_forward(q, k, v, causal), sets),
           "plain_ms": time_ms(lambda q, k, v: fa.mha_reference_lse(q, k, v, causal), sets),
           "library_ms": time_ms(sdpa, sets), "bound_ms": b_ms, "bound_by": b_by}
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
    b_ms, b_by = bound_ms(accel, nbytes, 4.0 * B * H * n_valid * Dh, dtype)
    sdpa = lambda q, k, v, p: F.scaled_dot_product_attention(
        q.view(B, H, 1, Dh), k[:, :n_valid].transpose(1, 2), v[:, :n_valid].transpose(1, 2),
        scale=1.0 / math.sqrt(Dh), enable_gqa=True)
    row = {"name": name, "shape": [B, S, H, KV, Dh], "pos": pos, "dtype": str(dtype),
           "max_abs_err": err, "tol": TOL[dtype]["o"],
           "ms": time_ms(da.decode_attention, sets),
           "plain_ms": time_ms(da.decode_reference, sets),
           "library_ms": time_ms(sdpa, sets), "bound_ms": b_ms, "bound_by": b_by}
    emit("kernel decode_attention", **row)
    return row


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
    fa.KERNEL.launches = da.KERNEL.launches = 0
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


def device_profile(fn):
    """Run fn() under torch.profiler: host wall ms, device ms summed over
    kernels, the device's idle share of the wall time, and the top kernels.
    The profiler's own overhead lengthens the wall time."""
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
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": max(0.0, 1 - device_ms / wall_ms),
            "top": [[e.key[:70], dev(e), e.count] for e in rows[:6]]}


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

    build_s = op_builder.build_all([fa.KERNEL, da.KERNEL])
    emit("build", seconds=build_s,
         ptxas={k.name: ptxas_summary(k.build_log) for k in (fa.KERNEL, da.KERNEL)})

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf, f32 = torch.bfloat16, torch.float32
    flash_rows = [check_flash(fa, accel, gen, *case) for case in (
        ("slice", BATCH, PROMPT, 32, 64, bf, True),
        ("t1", BATCH, 1, 32, 64, bf, True),
        ("t100_ragged", BATCH, 100, 32, 64, bf, True),
        ("noncausal", BATCH, PROMPT, 32, 64, bf, False),
        ("d96", BATCH, PROMPT, 32, 96, bf, True),
        ("d128", BATCH, PROMPT, 32, 128, bf, True),
        ("fp32", BATCH, PROMPT, 32, 64, f32, True))]
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

    model_cls, presets = resolve_family(MODEL)
    launches = serve_slice(deepspeed_tpu_torch.init_inference, model_cls, presets[MODEL],
                           accel, fa, da)
    serve_small_fp32(deepspeed_tpu_torch.init_inference, model_cls, presets[MODEL])

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:123",
         "launches": launches["flash_attention_fwd"],
         **{k: flash_rows[0][k] for k in keys}},
        {"name": "decode_attention", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
         "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:47",
         "launches": launches["decode_attention"],
         **{k: decode_rows[0][k] for k in keys}},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
