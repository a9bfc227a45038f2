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
``serve llama3.2-1b int8`` and ``int4`` serve the same model with
weight-quantized weights (``init_inference(dtype=torch.int8, quant=...)``,
each block dequantized inside the captured step): its launches, greedy
tokens equal bit for bit to the dequantized weights served in bf16, and
its prefill ms, tokens/s, weight bytes and peak beside the bf16 line's.
``serve_frontend llama3.2-1b`` puts the same engine behind the serving
front-end (``serving.from_ds_config`` with the ``serving`` and
``telemetry`` blocks; B = 1 a request, ticks of 16 tokens): 8 greedy
requests counted and equal to ``generate`` bit for bit, a sampled one, a
queue-full shed, a chaos hang on a decode tick, the circuit opening and
closing under an armed flight recorder (``blackbox.configure``: one
``breaker_transition`` bundle, the sheds and transitions in its ring), a
drain with exit code 87; K1 and K3 are checked at its B = 1 shapes.
``resilience gpt2-760m`` trains the dense cell again with the ``watchdog``
block (a heartbeat file, the step agreement every step), the bad-step
sentinel, the ``rewind`` ring (``ram_interval`` 4, ``keep`` 2) and the
``blackbox`` flight recorder: losses equal to the unarmed cell's bit for
bit, K1 and each K2 entry once per layer a step, the snapshot ms, the host
GB held and the heartbeat's advancing mtime, the recorder's µs a step and
no bundle, then a forced bundle (its bytes, files and write ms) and the
incident report over it; then three drills at 4 of its 24 layers, each
under ``DSElasticAgent``: a chaos hang on the ``train_step`` hook ends in
the watchdog's ``WatchdogTimeout`` and a restart from the RAM tier whose
losses equal an unfaulted run's bit for bit, with the recorder armed (the
``watchdog_timeout`` bundle, the restart's own rate-limited, one bundle
for one SIGUSR1, the incident report naming the timeout as the first cause
with the restart's recovery, ``ds_metrics``'s incident line and
``ds_report``'s card line); a loss spike (one batch repeated until its
loss falls, then fresh ones) is rewound in place from RAM with no disk,
once, its ``sentinel_rewind`` the report's first cause; a chaos
``preempt`` stops the run with an
``emergency_step<N>`` tag that an engine from another seed loads, in
preference to the stale ``latest``, bit for bit (the save's seconds,
bytes and host peak).
``profiled gpt2-760m`` trains the dense cell again with ``csv_monitor``,
``tensorboard``, ``telemetry.monitor``, ``profiling`` (a memory census
every step) and ``flops_profiler`` at the 3rd timed step: losses equal to
the unarmed cell's bit for bit, K1 and each K2 entry once per layer a
step, the CSV's losses equal to the run's, the counted flops equal to the
closed form (``matmul_flops``) and, for 2 of its layers, to the CPU's
count, and the census's state bytes and total (the allocator's).
``train gpt2-760m activation_checkpointing`` trains the dense cell with
DeepSpeed-Chat's ``activation_checkpointing`` block (losses equal to the
plain run's bit for bit), and its hand loop calls
``checkpointing.checkpoint`` around each block with ``cpu_checkpointing``
off and on (step ms, peak, gradients against the model's own remat).
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
destroys the group. ``launch gpt2-760m`` starts the stage-1 recipe from the
command line (``python -m deepspeed_tpu_torch.launcher.runner --num_gpus
1`` on a user script written to a temporary directory) and holds the
launched process's environment, launches and losses to the in-process
stage-1 run; its ``telemetry`` and ``goodput`` blocks are armed, and its
first step's ``compile`` bucket holds the kernels' builds (their loads,
where the libraries were built before). Then it feeds, saves and resumes
gpt2-760m at full width, 4 of its 24 layers (``resume``): a token dataset written with
the port's indexed-dataset builder into a temporary directory, engine A
trained through ``initialize(training_data=...)``'s loader, saved with the
default async save and trained on, engines B and C built from other seeds
loading the tag and training on through their restored loaders; it holds
the state after each load to the saved state bit for bit, B's batches to
A's, and B's losses to A's as closely as to C's, and reports the tag's
bytes, the save's blocking and commit seconds, the write and read rates
and the data wait per step; ``serve gpt2-760m`` serves engine A's tag
through ``init_inference(config={"checkpoint": ...})`` (params bit for
bit, the graphed ``generate`` against the ungraphed loop and the plain
path, K1 per prefill and K3 per decode step at one query head per KV
head). ``curriculum`` trains the same model under the
legacy ``curriculum_learning`` block, T growing through ragged lengths to
1024 (the kernel checks hold the forward and both backward kernels against
their plain versions at each of those lengths), and reports the data wait
with the host truncation; ``resume ... 2-layer ladder`` truncates a file of the newest of two
tags (load falls back to the older), loads a corrupt tag by name (nothing
loads) and a model of another head count (``CheckpointLayoutError``). The
directory is removed afterwards. Then the llama and BERT families train:
``train llama3.2-1b`` (the full preset, 4 x 2048, remat "full": 32 K1 and
16 of each K2 entry a step) at ZeRO stage 1, ``... zero3`` at stage 3, and
``offload llama3.2-1b`` with the optimizer state, the master and the params
in pinned host memory from a ``zero.Init`` build, their losses held to
stage 1's; the 2-layer kernel-vs-plain checks; ``serve llama3.2-1b from its
tag`` serves a stage-1 tag of the preset at 4 of its 16 layers
(``LLAMA_TAG_LAYERS``; params bit for bit, one K1 per layer and
``generate``, one K3 per layer and decode step), which ``consolidate``
writes in HF's layout. ``train bert-large seq128`` (64 x
128) and ``seq512`` (16 x 512) train masked-LM with LAMB in fp16 under
dynamic loss scaling, each step launching 24 K1 and 24 of each K2 entry,
non-causal; ``train check bert-large ...`` holds 2 layers to the plain
path, and a step with an ``attention_mask`` launches no kernel (the plain
masked path, as in JAX). Then the MoE family: ``train gpt2-moe-125m`` (the
gpt2-125m trunk, 12 layers, an 8-expert top-1 bank on every odd block,
12 x 1024, remat per dense/MoE pair: 24 K1 and 12 of each K2 entry a step)
at ZeRO stage 1 with its routing (``l_aux``, the share of tokens dropped,
the largest expert load over the mean) and a profile with the gate,
dispatch, experts and combine as ranges of their own, its tag saved;
``... zero3`` over a NCCL group of one, its losses held to stage 1's; the
2-layer kernel-vs-plain checks (with the share of tokens the two bf16
paths route to other experts); ``... offloaded`` (stage 2,
``offload_optimizer`` cpu) and ``... zero.Init`` (stage 3 from a
``zero.materialize`` build), their losses held to stage 1's; ``...
sparse-fixed16`` (the "fixed" layout at block 16: K4a twice and K4b and
K4c once per layer and step, no dense kernel) with one dense/MoE pair held
to the plain path in bf16 and fp32; ``serve gpt2-moe-125m from its tag``
(12 K1 per ``generate``, 12 K3 per decode step). Last, ``serve sd1.5`` serves the
stable-diffusion stack at its published widths in bf16 through
``init_inference``: CLIP ViT-L/14's text tower encodes 2 prompts and their
unconditional rows (12 causal K1 at T = 77), SD-1.5's UNet runs 4 guided
steps on a 64 x 64 latent through ``engine.forward(sample, t, context)`` (32
K1 a forward: head dims 40, 80 and 160, self-attention and cross-attention
over 77 keys), the VAE decodes the latents (K1 at head dim 512) and its
engine round-trips one 512 x 512 image; the K1 calls by shape, the outputs
against the same models with the plain attention, ms per forward and a
profile of one UNet forward; ``check sd1.5 fp32 2-block`` holds two UNet
blocks, a two-block VAE and two CLIP layers in fp32 to the plain path.
Then the GPT-2 variant families (``VARIANT_MODELS``, their published
widths, random weights): ``train pythia-1.4b attn`` (GPT-NeoX: partial
rotary, the parallel residual, an untied head; 4 x 2048, stage 1) launches
24 K1 and 24 of each K2 entry a step, the recompute reading K1's outputs
back; ``... full`` and ``... dots`` launch 48 K1, their losses held to
"attn"'s; ``train check pythia-1.4b dropout`` holds 2 fp32 layers under
remat "attn" to remat off on the same generator seeds; ``serve
pythia-1.4b``, ``opt-1.3b``, ``gpt-neo-1.3b`` (prompt 384, past its
256-slot window: K1 and K3 on the 12 global layers) and ``bloom-560m``
(ALiBi: no kernel) ``from hf`` build HF-shaped state dicts on the card
(``hf_lm_state``), load them through ``load_hf_model`` with a dict config
and serve them through the graphed decode loop against the ungraphed one
and the plain path; ``serve gpt-j-6b`` serves GPT-J-6B (head dim 256,
interleaved rotary) from the port's own init, and ``serve check gpt-j-6b
loader 2-layer`` its loader at its widths; ``train bert-large pld`` trains
under the ``progressive_layer_drop`` block, each step's θ held to
``theta_at``, beside the same run without it. K1 and K3 are checked at
head dim 256 at GPT-J-6B's shapes. Then model import: ``import
llama3.2-1b from hf`` builds an HF-shaped llama3.2-1b dict on the card
(``hf_lm_state``), loads it through ``load_hf_model`` (its config held to
the registry preset's) and serves it like ``slice llama3.2-1b``, its greedy
tokens equal to a preset model's on the same weights; ``import bert-large
from hf`` and ``import distilbert-base from hf`` load masked-LM dicts and
serve ``init_inference``'s forward at 16 x 512 (one non-causal K1 per
layer), bf16 and 2 fp32 layers against the plain path; ``export round
trip`` reads ``export_llama`` (2 of llama3.2-1b's 16 layers),
``export_gpt2`` (gpt2-760m) and ``export_bloom`` (BLOOM-560m) back through
their loaders bit for bit; ``consolidate llama3.2-1b arch llama`` (in the
llama training phases) writes the stage-1 tag as an HF file and reads it
back to the tag's params; ``serve megatron gpt2-760m`` (tp 2) and ``serve
megatron gpt2-moe-125m`` write Megatron-DeepSpeed directories (fp16) and
serve them through ``init_inference(model=None, checkpoint=...,
checkpoint_config={"type": ...})``, their greedy tokens equal to the same
weights served from the port's state dict. Then the RLHF actor: ``hybrid
opt-1.3b`` runs DeepSpeed-Chat's actor loop on OPT-1.3b through the hybrid
engine (16 prompts of 256, 256 greedy new tokens through the graphed decode
loop over the live params, equal to the ungraphed loop bit for bit, then a
``train_batch`` on the answers, three times, one decode graph for the whole
run); ``train gpt2-760m compression`` trains the training cell under MoQ
(8 -> 4 bits) and l1 pruning through every stage, then holds
``redundancy_clean``'s weights to their levels, zeros and the terminal
transform, with the compressed path's bf16 and fp32 kernel-vs-plain
checks; ``train gpt2-760m compression zero3`` trains the same cell at ZeRO
stage 3 (the blocks' weights fetched and served compressed by their
gathers) over a NCCL group of one with the ``telemetry`` trace and the
``goodput`` meter, its losses held to the stage-1 cell's, every step's
goodput buckets summing to its wall timed apart, its comm spans well
formed, the goodput fraction and MFU beside the device's busy share, the
goodput report and the live view run on its directory, and its bf16 and
fp32 kernel-vs-plain checks at stage 3; ``train gpt2-760m compression
offload`` trains it under ``offload_param: cpu`` (the compressed values
in pinned host memory), its extra card memory over the cell without the
block held to twice the largest stacked leaf; ``eigenvalue gpt2-760m`` runs the block Hessian eigenvalue after
each step (no K1 or K2 inside an estimate) and holds an fp32 estimate on
the card to the CPU's. The kernel rows that no summary
reports (edge lengths, other types and head dims, and the type and
tile-edge variants of the model shapes' rows) are checked without a time
(``untimed``). Each phase prints one JSON line with the seconds
since the start (``at_s``); any failed check raises, and the script exits
non-zero without the final line. It needs one card and imports nothing of
JAX or of the JAX package.

The last lines are: the kernels' summary as ``{"kernels": [...]}``, the
card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Timing: each kernel time is CUDA-event device time per call, averaged over
``ITERS`` back-to-back calls (the plain versions over ``PLAIN_ITERS``)
queued behind a device sleep (so host launch
overhead does not show), with inputs rotated over copies totalling more than
the 50 MB L2 cache, as the model's per-layer calls find them cold.
``bound_ms`` is max(bytes moved / memory bandwidth, operations / peak rate
for the input type), from the accelerator's published peaks, counting each
input read once and each output written once. A training step is timed on
the host clock from the call to the loss on the host, step by step after
warm-up steps; the median is reported with every step's time.
"""

import contextlib
import dataclasses
import gc
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SEED = 0
ITERS = 20
PLAIN_ITERS = 5                     # the plain versions, 10-1000x slower, over fewer calls
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
# the activation_checkpointing phase: DeepSpeed-Chat's block (its
# training scripts' ds_config), the hand loop's timed steps, and the bf16
# gradient limit against the model's own remat
AC_BLOCK = {"partition_activations": False, "cpu_checkpointing": False,
            "contiguous_memory_optimization": False, "number_checkpoints": None}
AC_STEPS = 3
AC_GRAD_RTOL = 5e-2
# the ZeRO phase: the training cell's recipe at each stage, over a NCCL
# process group of one
ZERO_STAGES = (0, 1, 2, 3)
# the resume phase: a token dataset written with the port's indexed-dataset
# builder, steps before and after the save, and the disk the tag needs
RESUME_SAMPLES, RESUME_STEPS = 64, 3
STATE_BYTES_PER_PARAM = 14          # bf16 params, fp32 masters, two fp32 moments
# the resume phase's depth: 4 of gpt2-760m's 24 layers, for the script's
# time (its checks, and those of serving its tag, hold at any depth; the
# tag is ~2.7 GB)
RESUME_LAYERS = 4
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
# the five gpt2-2.7b offload runs at an eighth of the preset's depth (full
# width; 8 layers in PRs 14-16): the script's time limit stays while it
# grows, and each run's placement and policy are the same at 4 layers as
# at 32
OFFLOAD_LAYERS = 4
OFFLOAD_CONFIG = {**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": OFFLOAD_BATCH}
OFFLOAD_KNOBS = ("DS_TPU_OFFLOAD_MASTER", "DS_TPU_FORCE_STREAMED_OFFLOAD",
                 "DS_TPU_OFFLOAD_CHUNK_BYTES", "DS_TPU_OFFLOAD_OVERLAP")
HOST_BYTES_PER_PARAM = 12           # fp32 master and two fp32 moments in host memory
HOST_MARGIN = 6e9                   # host memory left for the run beside that state
# gpt2-6.7b at the fewest layers whose 18 B/param (bf16 params, fp32
# master, moments and gradients) exceed the card's 85.5 GB (80 GiB): the
# model the card cannot hold, in the least time
CAPACITY_LAYERS = 23
# its steps, cut from the training cell's 2 warm-up and 5 timed (~4.6 s
# each) for the script's time limit
CAPACITY_WARMUP, CAPACITY_STEPS = 1, 2
# the NVMe and offloaded-resume phases: gpt2-125m's width at 2 layers, 4 x
# 1024 (gpt2-2.7b's at 2 layers until the monitoring and profiling phase
# came: its 129 M-parameter embedding set the phases' ~90 s; the swap's and
# the Infinity engine's placement, policy and code are the same at any
# width); the swap through 8 I/O threads
NVME_MODEL = "gpt2-125m"
NVME_LAYERS, NVME_WARMUP, NVME_STEPS = 2, 1, 1
NVME_BATCH, NVME_SEQ = 4, 1024
NVME_CONFIG = {**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": NVME_BATCH}
NVME_AIO = {"block_size": 1 << 20, "thread_count": 8}
AIO_COUNTS = ("direct_chunks", "buffered_chunks", "direct_bytes", "buffered_bytes")
# the fp32 NVMe check: two AdamW steps, for the script's time
NVME_FP32 = dict(layers=2, batch=2, seq=1024, steps=2)
NVME_LOSS_RTOL = 1e-2               # bf16: the Infinity engine keeps the top-level weights
                                    # in fp32 where the engine rounds them to bf16

# the llama and BERT training phases: llama3.2-1b at 4 x 2048 with the
# training recipe; bert-large with the reference's BERT pretraining recipe
# (LAMB, fp16 with dynamic loss scaling, clipping 1.0) at its two sequence
# lengths, (batch, seq, max_predictions_per_seq) each
LLAMA_BATCH, LLAMA_SEQ = 4, 2048
# the llama tag (saved, served, consolidated) at 4 of the preset's 16 layers
LLAMA_TAG_LAYERS = 4
BERT_MODEL = "bert-large"
BERT_SHAPES = ((64, 128, 20), (16, 512, 80))
BERT_CONFIG = {"train_micro_batch_size_per_gpu": 64, "gradient_accumulation_steps": 1,
               "optimizer": {"type": "Lamb", "params": {"lr": 1e-3, "weight_decay": 0.01,
                                                        "bias_correction": False,
                                                        "max_coeff": 0.3, "min_coeff": 0.01}},
               "fp16": {"enabled": True, "loss_scale": 0}, "zero_optimization": {"stage": 1},
               "gradient_clipping": 1.0, "steps_per_print": 0, "seed": SEED}

# the MoE training phases: gpt2-moe-125m at the JAX bench's 12 x 1024 with
# the training recipe, the expert axis 1 (one card)
MOE_MODEL = "gpt2-moe-125m"
MOE_EXPERTS = 8                     # the registry's gpt2-moe expert count
MOE_BATCH, MOE_SEQ = 12, 1024
MOE_CONFIG = {**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": MOE_BATCH,
              "tpu": {"expert": 1}}
# the MoE layer's profiler ranges (forward and remat recompute) and the
# backward nodes of its expert products and gathers
MOE_RANGES = {"gate": r"^moe_gate$", "dispatch": r"^moe_dispatch$",
              "experts": r"^moe_experts$", "combine": r"^moe_combine$",
              "bmm backward": r"BmmBackward0$", "gather backward": r"IndexBackward0$"}

# the stable-diffusion serving phase: SD-1.5's UNet and VAE
# (runwayml/stable-diffusion-v1-5 unet/ and vae/config.json, the JAX
# package's defaults) and CLIP ViT-L/14's text tower
# (openai/clip-vit-large-patch14), bf16 with seed-0 random weights through
# init_inference. One request: SD_PROMPTS prompts with classifier-free
# guidance (a conditional and an unconditional row each), SD_STEPS UNet steps
# on a 64 x 64 latent (512 x 512 images), the VAE's decode of the latents, and
# the VAE engine's round trip of one image. The update between steps stands
# in for a scheduler (the JAX package has none).
SD_PROMPTS, SD_STEPS, SD_LATENT, SD_TOKENS = 2, 4, 64, 77
SD_GUIDANCE, SD_STEP_SIZE = 7.5, 0.1
SD_TIMED = 5                        # timed forwards of each model, after the request
CLIP_L14 = dict(vocab_size=49408, n_positions=77, n_embd=768, n_layer=12, n_head=12,
                activation="quick_gelu", remat=False)
CLIP_BOS, CLIP_EOS = 49406, 49407   # the tokenizer's; SD-1.5 pads with EOS

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
# SD-1.5's bf16 outputs (CLIP's hidden states, the UNet's noise prediction,
# the VAE's images), kernel path vs the same model with the plain attention,
# as a share of the output's largest |value|: the plain path rounds scores
# and probabilities to bf16, the kernel keeps them in fp32. The fp32 2-block
# models are held to FP32_RTOL of their largest |value|.
SD_RTOL = 5e-2
# the fp32 2-layer NVMe runs against the engine in memory: the same model
# path, AdamW on the host (fused multiply-adds of the CPU) against the card's
FP32_NVME_RTOL = 1e-5


# the GPT-2 variant families at their published widths (the HF configs of
# EleutherAI/pythia-1.4b, EleutherAI/gpt-j-6b, facebook/opt-1.3b,
# EleutherAI/gpt-neo-1.3B and bigscience/bloom-560m), on GPT2Config's
# switches; random weights
VARIANT_MODELS = {
    "pythia-1.4b": dict(vocab_size=50304, n_positions=2048, n_embd=2048, n_layer=24,
                        n_head=16, activation="gelu", rotary_pct=0.25, rotary_theta=10000.0,
                        parallel_residual=True, tie_embeddings=False),
    "gpt-j-6b": dict(vocab_size=50400, n_positions=2048, n_embd=4096, n_layer=28, n_head=16,
                     rotary_pct=0.25, rotary_interleaved=True, parallel_residual=True,
                     tie_embeddings=False, lm_head_bias=True),
    "opt-1.3b": dict(vocab_size=50272, n_positions=2048, n_embd=2048, n_layer=24, n_head=32,
                     activation="relu"),
    "gpt-neo-1.3b": dict(vocab_size=50257, n_positions=2048, n_embd=2048, n_layer=24,
                         n_head=16, attention_layers=("global", "local") * 12, window_size=256),
    "bloom-560m": dict(vocab_size=250880, n_positions=2048, n_embd=1024, n_layer=24,
                       n_head=16, alibi=True, embed_layernorm=True),
}
PYTHIA = "pythia-1.4b"
PYTHIA_BATCH, PYTHIA_SEQ = 4, 2048
PYTHIA_REMATS = ("attn", "full", "dots")
NEO_PROMPT = 384                    # past GPT-Neo's 256-slot window
GPTJ_LOADER_LAYERS = 2              # the GPT-J loader checked at its widths on 2 layers
# the fp32 2-layer dropout check, remat "attn" against remat off on the same
# generator seeds: gradients relative to each tensor's L2 norm
DROPOUT_CHECK = {"batch": 2, "seq": 512, "p": 0.1, "rtol": 1e-6}
PLD = {"enabled": True, "theta": 0.5, "gamma": 0.001}
# GPT-Neo at HF's init, bf16 against fp32 on each seed: the kernel path's
# max and mean logit errors within ``ratio`` times the plain path's
NEO_HF_INIT = {"seeds": (SEED + 3, SEED + 4), "ratio": 1.25}
# model import: DistilBERT-base's published widths on BertConfig (6 layers,
# d 768, 12 heads, hidden_dim 3072, no token types; vocab 30522 and 512
# positions, as bert-large), and the MLM forward's batch x sequence
DISTILBERT = dict(n_embd=768, n_layer=6, n_head=12, intermediate_size=3072, type_vocab_size=1)
IMPORT_BERT_SHAPE = (16, 512)

_T0 = time.perf_counter()


# each phase's last line, for the phases that report beside another's
LINES = {}


def emit(phase, **fields):
    LINES[phase] = fields
    print(json.dumps({"phase": phase, "at_s": time.perf_counter() - _T0, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


_UNTIMED = [False]


@contextlib.contextmanager
def untimed():
    """Kernel checks inside check correctness only: ``time_ms`` gives None
    (the rows no summary reports; a check of the same shape class is timed
    elsewhere)."""
    _UNTIMED[0] = True
    try:
        yield
    finally:
        _UNTIMED[0] = False


def _per(num, ms):
    """``num / ms``, None for an untimed row."""
    return None if ms is None else num / ms


def time_ms(fn, arg_sets, iters=ITERS):
    """Device ms per call of fn(*args) over ``iters`` calls, args rotated
    over ``arg_sets``; None inside ``untimed``."""
    if _UNTIMED[0]:
        return None
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)   # holds the device while the host queues the calls
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _side_row(name: str) -> bool:
    """A type or tile-edge variant of a model shape's row: held to its plain
    version without a time (the model shape's own row is timed)."""
    return name.endswith(("_fp16", "_fp32", "_fp32_noncausal")) or "_edges_" in name


def _checked(check, name, *args):
    """``check(*args)`` (a kernel row), untimed for a :func:`_side_row`."""
    with untimed() if _side_row(name) else contextlib.nullcontext():
        return check(*args)


def n_copies(set_bytes: int) -> int:
    """Input sets a row rotates over: past the L2 cache when it is timed,
    one inside ``untimed`` (the checks read the first set only)."""
    if _UNTIMED[0]:
        return 1
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
    tensor-core instance (``*_mma_kernel<type, D>``, the forward's
    ``flash_fwd_wide_kernel<type, 512>``) its registers and
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
    mma = {n: v for n, v in per.items() if re.search(r"_(mma|wide)_kernel<", n)}
    if mma:
        out["mma_instances"] = mma
    return out


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# ------------------------------------------------------------------ kernels
def _pairs(t_q: int, t_k: int, causal: bool) -> int:
    """Visible (query, key) pairs of one head, top-left causal."""
    return sum(min(i + 1, t_k) for i in range(t_q)) if causal else t_q * t_k


def sdpa_backend(q, k, v, causal: bool) -> str:
    """The backend PyTorch's SDPA dispatch picks for these inputs (its
    flash backend refuses head dims past 256)."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, None, 0.0, causal, scale=1.0)).name


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
           "bitwise_repeat": repeat, "library_backend": sdpa_backend(
               q.view(B, H, T, D), k.view(B, H, Tk, D), v.view(B, H, Tk, D), causal),
           "ms": time_ms(lambda q, k, v: fa.flash_forward(q, k, v, causal), sets),
           "plain_ms": time_ms(lambda q, k, v: fa.mha_reference_lse(q, k, v, causal), sets,
                               PLAIN_ITERS),
           "library_ms": time_ms(sdpa, sets), "bound_ms": b_ms, "bound_by": b_by}
    row["tflops"] = _per(4.0 * D * _pairs(T, Tk, causal) * B * H / 1e9, row["ms"])
    row["bound_share"] = _per(b_ms, row["ms"])
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
           "plain_ms": time_ms(da.decode_reference, sets, PLAIN_ITERS),
           "library_ms": time_ms(sdpa, sets), "bound_ms": b_ms, "bound_by": b_by}
    row["tflops"] = _per(ops / 1e9, row["ms"])
    row["gbytes_per_s"] = _per(nbytes / 1e6, row["ms"])
    row["bound_share"] = _per(b_ms, row["ms"])
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
           "dq_plain_ms": time_ms(lambda *a: fa.mha_backward_dq_reference(*a, causal), sets,
                                  PLAIN_ITERS),
           "dkv_plain_ms": time_ms(lambda *a: fa.mha_backward_dkv_reference(*a, causal), sets,
                                   PLAIN_ITERS),
           "dq_bound_ms": dq_bound[0], "dq_bound_by": dq_bound[1],
           "dkv_bound_ms": dkv_bound[0], "dkv_bound_by": dkv_bound[1],
           "library_bwd_ms": time_ms(lib_bwd, lib), "library_fwd_bwd_ms": time_ms(lib_fwd_bwd, lib)}
    row["dq_tflops"] = _per(6.0 * D * pairs / 1e9, row["dq_ms"])
    row["dq_bound_share"] = _per(dq_bound[0], row["dq_ms"])
    row["dkv_tflops"] = _per(8.0 * D * pairs / 1e9, row["dkv_ms"])
    row["dkv_bound_share"] = _per(dkv_bound[0], row["dkv_ms"])
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
                             sets, PLAIN_ITERS),
        dq_plain_ms=time_ms(lambda *a: fa.sparse_backward_dq_reference(*a, layout, causal), sets,
                            PLAIN_ITERS),
        dkv_plain_ms=time_ms(lambda *a: fa.sparse_backward_dkv_reference(*a, layout, causal),
                             sets, PLAIN_ITERS))
    for entry in ops:   # visible-pair work only
        row[f"{entry}_tflops"] = _per(ops[entry] / 1e9, row[f"{entry}_ms"])
        row[f"{entry}_bound_share"] = _per(row[f"{entry}_bound_ms"], row[f"{entry}_ms"])

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


def _served_cell(engine, ids, accel, fa, da, label, kernel_layers=None, **fields):
    """The serving cell's counted main-path run on ``engine`` (its model
    serves with the kernels, bf16): the graphed ``generate`` of GEN greedy
    tokens on ``ids``, the ungraphed loop's tokens, and prefill and one
    decode step against the plain path on the same weights; emits the
    ``label`` line with ``fields``. ``kernel_layers``: the layers that
    launch K1 a prefill and K3 a step (every layer by default; a GPT-Neo
    local layer or an ALiBi layer takes the plain path). → (the second
    generate's launches, its decode loop, the decode step's logits and
    cache)."""
    model = engine.module
    c = model.config
    B, T = ids.shape
    kernel_layers = c.n_layer if kernel_layers is None else kernel_layers
    engine.generate(ids[:2, :8], max_new_tokens=2)   # warm-up (library handles)
    torch.cuda.synchronize()
    accel.reset_peak_memory_stats()
    out, first_s, gen_s, loop, first_launches, launches = _graphed_generate(
        engine, ids, GEN, fa, da, kernel_layers)
    peak_gb = accel.max_memory_allocated() / 1e9
    if tuple(out.shape) != (B, T + GEN) or not torch.equal(out[:, :T], ids) \
            or out.min().item() < 0 or out.max().item() >= c.vocab_size:
        raise AssertionError(f"generate output malformed: {tuple(out.shape)}")
    eager, eager_s = _eager_generate(engine, ids, GEN)
    if not torch.equal(eager, out):
        raise AssertionError(f"graphed and eager greedy tokens differ in "
                             f"{int((eager != out).sum().item())} places")

    # the same weights through the plain versions, selected by the model's own
    # flags (use_flash_attention / use_flash_decode off), not as a fallback
    plain = type(model)(dataclasses.replace(c, use_flash_attention=False,
                                            use_flash_decode=False))
    plain.load_state_dict(model.state_dict(), assign=True)
    # a MoE model's plain path routes as the kernel path did (train_check_bf16)
    moe = [layer.moe_layer for layer in getattr(model, "moe", ())]
    routing = {}
    with torch.inference_mode():
        for layer in moe:
            layer.record = True
        prefill_med, logits, cache = _prefill_ms(model, ids, T + GEN)
        routes = [layer.routing for layer in moe]
        for layer in moe:
            layer.record = False
        replay_ms = _replay_ms(loop, logits, cache, GEN)
        if moe:
            for layer in plain.moe:
                layer.moe_layer.record = True
            free, _ = plain.prefill(ids, plain.init_cache(B, T + GEN))
            plain_routes = [layer.moe_layer.routing for layer in plain.moe]
            for layer in plain.moe:
                layer.moe_layer.record = False
            _pin_routing(plain, routes)
        ref, ref_cache = plain.prefill(ids, plain.init_cache(B, T + GEN))
        tok = torch.argmax(logits, dim=-1)
        for layer in moe:
            layer.record = True
        step_k, _ = model.decode_step(tok, cache)
        for layer in moe:
            layer.record = False
        if moe:
            _pin_routing(plain, [layer.routing for layer in moe])
        step_p, _ = plain.decode_step(tok, ref_cache)
    if moe:
        routing = {"routing_pinned": True, "prefill_unpinned_logits_max_abs_err":
                   max_err(logits, free),
                   "prefill_routed_differently_share": sum(
                       (a["experts"] != b["experts"]).float().mean().item()
                       for a, b in zip(routes, plain_routes)) / len(routes),
                   "prefill_dropped_share": sum((r["weights"] == 0).float().mean().item()
                                                for r in routes) / len(routes)}
    scale = ref.abs().max().item()
    err_prefill, err_step = max_err(logits, ref), max_err(step_k, step_p)
    if not (torch.isfinite(logits).all() and torch.isfinite(step_k).all()) \
            or err_prefill > LOGIT_RTOL * scale or err_step > LOGIT_RTOL * step_p.abs().max().item():
        raise AssertionError(f"kernel path vs plain path: prefill logits err {err_prefill}, "
                             f"decode logits err {err_step}, |ref| max {scale}")
    decode_s = gen_s - prefill_med / 1e3
    eager_decode_s = eager_s - prefill_med / 1e3
    emit(label, **fields, batch=B, prompt=T, gen=GEN, dtype="bfloat16",
         heads=c.n_head, kernel_layers=kernel_layers,
         kv_heads=getattr(c, "n_kv_head", c.n_head), head_dim=c.head_dim,
         launches=launches, first_call_launches=first_launches, generate_s=gen_s,
         first_generate_s=first_s,
         capture_s=loop.capture_s, prefill_ms=prefill_med,
         decode_tok_s=B * GEN / decode_s, decode_ms_per_step=decode_s * 1e3 / GEN,
         replay_device_ms_per_step=replay_ms,
         eager_generate_s=eager_s, eager_decode_tok_s=B * GEN / eager_decode_s,
         eager_decode_ms_per_step=eager_decode_s * 1e3 / GEN, eager_tokens_identical=True,
         peak_mem_gb=peak_gb, prefill_logits_max_abs_err=err_prefill,
         decode_logits_max_abs_err=err_step, ref_logits_max_abs=scale,
         logit_rtol=LOGIT_RTOL,
         top1_agree=(logits.argmax(-1) == ref.argmax(-1)).float().mean().item(), **routing)
    return launches, loop, step_k, cache


def serve_slice(init_inference, LlamaModel, cfg, accel, fa, da):
    """llama3.2-1b, bf16, full width and depth: the counted main-path run,
    through the graphed decode loop, beside the ungraphed loop; then the
    same engine behind the serving front-end (``serve_frontend``). →
    (generate's launches, the front-end's)."""
    c = dataclasses.replace(cfg, use_flash_decode=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = LlamaModel(c).init_params(gen)
    engine = init_inference(model, {"dtype": "bfloat16", "max_out_tokens": PROMPT + GEN})
    ids = torch.randint(0, c.vocab_size, (BATCH, PROMPT), generator=gen, device="cuda")
    launches, loop, logits, cache = _served_cell(engine, ids, accel, fa, da, f"slice {MODEL}",
                                                 weight_bytes=engine.weight_nbytes())
    with torch.inference_mode():
        profile_slice(model, engine, loop, ids, logits, cache, c.n_layer)
    del loop, cache
    frontend_launches = serve_frontend(engine, c, fa, da)
    del engine, model
    # a front-end and its breaker refer to each other (the transition
    # callback): the cycle, and the engine it holds, go at a collection
    gc.collect()
    torch.cuda.empty_cache()
    return launches, frontend_launches


# the serving front-end's phase: 8 greedy requests (prompt, new tokens)
# within max_out_tokens = PROMPT + GEN, ticks of 16 tokens
FRONTEND_REQUESTS = ((16, 32), (128, 128), (40, 64), (96, 96), (64, 128), (24, 48),
                     (112, 80), (80, 112))
FRONTEND_SAMPLED = {"do_sample": True, "top_k": 50, "top_p": 0.9, "seed": 7}
FRONTEND_SERVING = {"decode_tick_tokens": 16, "decode_tick_timeout_s": 0.5,
                    "max_queue_depth": 8, "breaker_threshold": 2, "breaker_cooldown_s": 1.0,
                    "drain_grace_s": 0.1}
FRONTEND_HANG_S = 3.0


def _join_disowned_ticks(timeout: float) -> None:
    """Wait for the front-end's disowned tick threads: their wake-up must
    not meet a capture in another thread (``generate`` captures with
    capture_error_mode "global")."""
    from deepspeed_tpu_torch.utils import locks

    for rec in locks.framework_threads():
        if rec.owner == "watchdog" and rec.name.startswith("ds-deadline-serve-tick"):
            rec.thread.join(timeout)
            if rec.thread.is_alive():
                raise AssertionError(f"disowned tick {rec.name} still alive after {timeout} s")


def _breaker_forensics(rec, bb_dir) -> dict:
    """The breaker drill's recorder: one bundle, the breaker's trip to
    open; the admitted request's and the door's sheds, the serving
    transitions and the breaker's recovery in the ring."""
    ring = [(e["kind"], e["severity"], e["payload"].get("to") or e["payload"].get("reason"))
            for e in rec.ring_snapshot()]
    bundles = _bundles(bb_dir)
    out = {"ring": ring, "bundles": _triggers(bb_dir),
           "bundle": _bundle_summary(os.path.join(bb_dir, "incidents", bundles[0]))
           if bundles else None}
    want = [("breaker_transition", "error", "open"), ("shed_admitted", "warning", "circuit_open"),
            ("serving_transition", "warning", "degraded"), ("shed", "warning", "circuit_open"),
            ("breaker_transition", "info", "half_open"), ("breaker_transition", "info", "closed"),
            ("serving_transition", "info", "ready")]
    if out["bundles"] != ["breaker_transition"] or rec.bundles_written != 1 \
            or [r for r in ring if r[0] != "chaos_injection"] != want:
        raise AssertionError(f"breaker drill forensics: {out}")
    return out


def serve_frontend(engine, c, fa, da):
    """The serving front-end (``serving/``) over the serving phase's engine
    (llama3.2-1b, bf16, full width and depth, max_out_tokens PROMPT + GEN,
    B = 1 per request), built by ``from_ds_config`` with the serving and
    telemetry blocks: 8 greedy requests, counted (one K1 per layer per
    prompt, one K3 per layer per token and one more per layer for the
    capture's warm-up step), each equal to ``engine.generate`` bit for bit;
    a sampled request equal to ``generate`` with its seed; a queue-full shed
    with the worker stopped; a chaos hang on a decode tick against the
    0.5 s warm tick cap (a partial with reason timeout, the server ready,
    the next request equal to ``generate``: the disowned tick wrote nothing
    of it); two failed ticks opening the circuit, a queued request shed
    circuit_open, a probe after the cooldown closing it, under a flight
    recorder armed with ``blackbox.configure`` (serving has no ds_config
    key that arms it): one ``breaker_transition`` bundle, the sheds and the
    serving transitions in its ring; a SIGTERM-style drain mid-stream (a
    partial with reason drained, exit code 87). → the counted requests'
    launches."""
    from deepspeed_tpu_torch import blackbox, telemetry
    from deepspeed_tpu_torch.resilience.chaos import (ChaosInjector, install_chaos,
                                                      uninstall_chaos)
    from deepspeed_tpu_torch.runtime.config import BlackboxConfig, DeepSpeedConfig
    from deepspeed_tpu_torch.serving import ServingFrontEnd, ShedError, from_ds_config

    out_dir = tempfile.mkdtemp(prefix="serve_frontend_", dir=_scratch_dir()[0])
    bb_dir = os.path.join(out_dir, "blackbox")
    ds_cfg = DeepSpeedConfig({"serving": FRONTEND_SERVING,
                              "telemetry": {"enabled": True, "output_dir": out_dir,
                                            "trace": False, "flush_interval": 1000}})
    gen = torch.Generator().manual_seed(SEED + 19)
    prompts = [torch.randint(0, c.vocab_size, (1, t), generator=gen).numpy()
               for t, _ in FRONTEND_REQUESTS]
    fe = from_ds_config(engine, ds_cfg, start=True)
    try:
        # the counted main-path run: 8 greedy requests, queued at once
        fa.KERNEL.reset_launches()
        da.KERNEL.reset_launches()
        t0 = time.perf_counter()
        reqs = [fe.submit(p, max_new_tokens=n, deadline_s=600)
                for p, (_, n) in zip(prompts, FRONTEND_REQUESTS)]
        for r in reqs:
            r.result(timeout=600)
        served_s = time.perf_counter() - t0
        launches = {"flash_attention_fwd": fa.KERNEL.launches,
                    "decode_attention": da.KERNEL.launches}
        expect = {"flash_attention_fwd": c.n_layer * len(reqs),
                  "decode_attention": c.n_layer * (sum(n for _, n in FRONTEND_REQUESTS) + 1)}
        if launches != expect:
            raise AssertionError(f"front-end launch counts {launches}, expected {expect}")
        if any(r.status != "completed" for r in reqs):
            raise AssertionError(f"front-end requests not completed: "
                                 f"{[(r.status, r.reason) for r in reqs]}")
        greedy_key = (False, 1.0, 0, 1.0, None)
        capture_s = fe._programs[greedy_key].capture_s
        snap = {r["name"]: r for r in telemetry.get_registry().snapshot()}
        # the sampled request
        sampled = fe.submit(prompts[1], max_new_tokens=64, deadline_s=600,
                            **FRONTEND_SAMPLED).result(timeout=600)
        # a queue-full shed from a front-end whose worker is stopped
        idle = ServingFrontEnd(engine, DeepSpeedConfig(
            {"serving": {**FRONTEND_SERVING, "max_queue_depth": 2}}).serving, start=False)
        idle.submit(prompts[0], max_new_tokens=8)
        idle.submit(prompts[0], max_new_tokens=8)
        try:
            idle.submit(prompts[0], max_new_tokens=8)
            raise AssertionError("a third request was admitted past max_queue_depth 2")
        except ShedError as e:
            queue_full = {"reason": e.reason, "queue_depth": e.queue_depth,
                          "retry_after_s": e.retry_after_s}
        idle.close()
        if queue_full["reason"] != "queue_full" or queue_full["queue_depth"] != 2:
            raise AssertionError(f"queue-full shed: {queue_full}")
        # a hung decode tick: tick #1 is the prefill, #2 the first decode
        # chunk, #3 the second (so the request has tokens: a partial)
        install_chaos(ChaosInjector(hang_at={"decode_step": [3]}, hang_s=FRONTEND_HANG_S))
        t_hang = time.perf_counter()
        hung = fe.submit(prompts[2], max_new_tokens=64, deadline_s=600).result(timeout=600)
        hung_s = time.perf_counter() - t_hang
        uninstall_chaos()
        after_hang = fe.submit(prompts[3], max_new_tokens=96, deadline_s=600).result(600)
        state_after_hang = fe.state
        if (hung.status, hung.reason) != ("partial", "timeout") or hung_s > 2.0 \
                or state_after_hang != "ready" or after_hang.status != "completed":
            raise AssertionError(f"hang drill: {hung.status}/{hung.reason} in {hung_s} s, "
                                 f"state {state_after_hang}, next {after_hang.status}")
        _join_disowned_ticks(FRONTEND_HANG_S + 5.0)
        # two failed ticks open the circuit; the queued third is shed; the
        # flight recorder is armed for it
        rec = blackbox.configure(BlackboxConfig(output_dir=bb_dir, signal_snap=False))
        install_chaos(ChaosInjector(fail_at={"decode_step": [1, 2]}))
        trio = [fe.submit(prompts[0], max_new_tokens=32, deadline_s=600) for _ in range(3)]
        for r in trio:
            r.result(timeout=600)
        uninstall_chaos()
        breaker_open = fe.breaker.state
        try:
            fe.submit(prompts[0], max_new_tokens=8)
            raise AssertionError("admitted with the circuit open")
        except ShedError as e:
            open_shed = e.reason
        time.sleep(FRONTEND_SERVING["breaker_cooldown_s"] + 0.1)
        probe = fe.probe(timeout=600)
        if [(r.status, r.reason.split(":")[0]) for r in trio] != \
                [("failed", "error"), ("failed", "error"), ("shed", "circuit_open")] \
                or breaker_open != "open" or open_shed != "circuit_open" \
                or probe.status != "completed" or fe.breaker.state != "closed":
            raise AssertionError(f"breaker drill: {[(r.status, r.reason) for r in trio]}, "
                                 f"{breaker_open}, {open_shed}, probe {probe.status}, "
                                 f"{fe.breaker.state}")
        forensics = _breaker_forensics(rec, bb_dir)
        # the drain mid-stream
        streaming = threading.Event()
        long = fe.submit(prompts[0], max_new_tokens=PROMPT + GEN - 16, deadline_s=600,
                         stream=lambda toks: streaming.set())
        if not streaming.wait(600):
            raise AssertionError("the long request streamed nothing")
        fe.begin_drain("signal")
        code = fe.drain(timeout=600)
        long.result(timeout=600)
        if (long.status, long.reason) != ("partial", "drained") or code != 87 \
                or fe.state != "dead":
            raise AssertionError(f"drain: {long.status}/{long.reason}, exit {code}, "
                                 f"state {fe.state}")
        counts = dict(fe.counts)
    finally:
        uninstall_chaos()
        fe.close()
        blackbox.deconfigure()
        _join_disowned_ticks(FRONTEND_HANG_S + 5.0)
    # every served request against generate on the same prompt (main thread,
    # the front-end idle: no capture meets a tick)
    with torch.inference_mode():
        for r, p in zip([*reqs, after_hang], [*prompts, prompts[3]]):
            ref = engine.generate(p, max_new_tokens=len(r.tokens))[0, p.shape[1]:].tolist()
            if r.tokens != ref:
                raise AssertionError(f"front-end request {r.id}: tokens differ from generate "
                                     f"in {sum(a != b for a, b in zip(r.tokens, ref))} places")
        ref = engine.generate(prompts[1], max_new_tokens=64, **FRONTEND_SAMPLED)
        if sampled.tokens != ref[0, prompts[1].shape[1]:].tolist():
            raise AssertionError("the sampled front-end request differs from generate")
        # generate's graphed decode at B = 1 on the (128, 128) request's prompt
        t, n = FRONTEND_REQUESTS[1]
        ids = torch.from_numpy(prompts[1]).cuda()
        engine.generate(ids, max_new_tokens=n)
        telemetry.deconfigure()                 # plain generate for the timing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(ids, max_new_tokens=n)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        prefill_med, _, _ = _prefill_ms(engine.module, ids, t + n)
    r = reqs[1]
    fe_decode_s = r.finished_at - (r.submitted_at + r.ttft_s)
    chunk = FRONTEND_SERVING["decode_tick_tokens"]
    hist = lambda name, q: snap[f"serving/{name}"][q]
    emit(f"serve_frontend {MODEL}", nvidia_smi=nvidia_smi_line(), batch_per_request=1,
         requests=[list(x) for x in FRONTEND_REQUESTS], tick_tokens=chunk,
         max_out_tokens=PROMPT + GEN, launches=launches, served_s=served_s,
         tokens_identical_to_generate=True, sampled_identical_to_generate=True,
         ttft_p50_s=hist("ttft_seconds", "p50"), ttft_p99_s=hist("ttft_seconds", "p99"),
         decode_chunk_p50_s=hist("decode_chunk_seconds", "p50"),
         decode_chunk_p99_s=hist("decode_chunk_seconds", "p99"),
         prefill_p50_s=hist("prefill_seconds", "p50"),
         queue_wait_p50_s=hist("queue_wait_seconds", "p50"),
         frontend_decode_tok_s=(n - chunk) / fe_decode_s,
         generate_decode_tok_s=n / (gen_s - prefill_med / 1e3), generate_b1_s=gen_s,
         prefill_b1_ms=prefill_med, capture_s=capture_s, queue_full=queue_full,
         hang={"status": hung.status, "reason": hung.reason, "seconds": hung_s,
               "tokens": len(hung.tokens), "next_request_identical": True},
         breaker={"trio": [(x.status, x.reason.split(":")[0]) for x in trio],
                  "probe": probe.status, "state": "closed"},
         drain={"status": long.status, "reason": long.reason, "tokens": len(long.tokens),
                "exit_code": code}, counts=counts, blackbox=forensics)
    shutil.rmtree(out_dir, ignore_errors=True)
    return launches


def serve_quantized(init_inference, LlamaModel, cfg, accel, fa, da, bits):
    """llama3.2-1b (the serving cell's model and ids, the same seed) served
    weight-quantized: ``init_inference(dtype=torch.int8, quant={"weight":
    {"num_bits": bits}})``, the compute in bf16, each block's weights
    dequantized just before it runs (inside the captured decode step). The
    counted graphed ``generate`` (B 32, prompt 128, 128 new, greedy; 16 K1
    a ``generate``, 16 K3 a decode step) must give, bit for bit, the tokens
    of the same model served in bf16 from the dequantized weights; prefill
    and one decode step against the plain path on those weights at
    LOGIT_RTOL. Reported beside the bf16 serving cell's line: prefill ms,
    graphed tokens/s, the weight bytes the engine holds and the peak of the
    ``generate``. → the second ``generate``'s launches."""
    from deepspeed_tpu_torch.ops.quantizer import dequantize_params

    c = dataclasses.replace(cfg, use_flash_decode=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = LlamaModel(c).init_params(gen)
    ids = torch.randint(0, c.vocab_size, (BATCH, PROMPT), generator=gen, device="cuda")
    bf16_bytes = sum(p.numel() * 2 for p in model.parameters())
    t0 = time.perf_counter()
    engine = init_inference(model, {"max_out_tokens": PROMPT + GEN}, dtype=torch.int8,
                            quant={"weight": {"num_bits": bits}})
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    held = engine.weight_nbytes()
    engine.generate(ids[:2, :8], max_new_tokens=2)    # warm-up (library handles)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    accel.reset_peak_memory_stats()
    out, first_s, gen_s, loop, first_launches, launches = _graphed_generate(
        engine, ids, GEN, fa, da, c.n_layer)
    peak_gb = accel.max_memory_allocated() / 1e9
    with torch.inference_mode():
        prefill_med, logits, cache = _prefill_ms(model, ids, PROMPT + GEN)
        replay_ms = _replay_ms(loop, logits, cache, GEN)
    decode_s = gen_s - prefill_med / 1e3

    # the same weights dequantized, served in bf16: the same tokens, bit for
    # bit; and the plain path on them
    quantized = {n: q for n, q in engine.quantized.items()}
    dense = {n: p for n, p in model.named_parameters() if not p.is_meta}
    dense.update(dequantize_params(quantized, torch.bfloat16))
    ref_model = LlamaModel(c)
    ref_model.load_state_dict(dense, assign=True)
    ref = init_inference(ref_model, {"dtype": "bfloat16", "max_out_tokens": PROMPT + GEN})
    ref_out = ref.generate(ids, max_new_tokens=GEN)
    if not torch.equal(ref_out, out):
        raise AssertionError(f"int{bits} tokens differ from the dequantized bf16 model's in "
                             f"{int((ref_out != out).sum().item())} places")
    plain = LlamaModel(dataclasses.replace(c, use_flash_attention=False, use_flash_decode=False))
    plain.load_state_dict(dense, assign=True)
    with torch.inference_mode():
        ref_logits, _ = ref_model.prefill(ids, ref_model.init_cache(BATCH, PROMPT + GEN))
        p_logits, p_cache = plain.prefill(ids, plain.init_cache(BATCH, PROMPT + GEN))
        tok = torch.argmax(logits, dim=-1)
        step_k, _ = model.decode_step(tok, cache)
        step_p, _ = plain.decode_step(tok, p_cache)
    scale = p_logits.abs().max().item()
    err_prefill, err_step = max_err(logits, p_logits), max_err(step_k, step_p)
    if not (torch.isfinite(logits).all() and torch.isfinite(step_k).all()) \
            or err_prefill > LOGIT_RTOL * scale \
            or err_step > LOGIT_RTOL * step_p.abs().max().item():
        raise AssertionError(f"int{bits}: kernel path vs plain path: prefill logits err "
                             f"{err_prefill}, decode logits err {err_step}, |ref| max {scale}")
    bf16_line = LINES[f"slice {MODEL}"]
    emit(f"serve {MODEL} int{bits}", batch=BATCH, prompt=PROMPT, gen=GEN, compute="bfloat16",
         num_bits=bits, group_size=128, quantized_tensors=len(quantized),
         quantized_params=sum(math.prod(q.shape) for q in quantized.values()),
         quantize_s=quantize_s, weight_bytes=held, weight_bytes_bf16=bf16_bytes,
         weight_bytes_bf16_phase=bf16_line["weight_bytes"],
         launches=launches, first_call_launches=first_launches,
         generate_s=gen_s, first_generate_s=first_s, capture_s=loop.capture_s,
         prefill_ms=prefill_med, prefill_ms_bf16_phase=bf16_line["prefill_ms"],
         decode_tok_s=BATCH * GEN / decode_s,
         decode_tok_s_bf16_phase=bf16_line["decode_tok_s"],
         replay_device_ms_per_step=replay_ms,
         replay_device_ms_per_step_bf16_phase=bf16_line["replay_device_ms_per_step"],
         peak_mem_gb=peak_gb, peak_mem_gb_bf16_phase=bf16_line["peak_mem_gb"],
         tokens_equal_dequantized_bf16=True,
         prefill_logits_equal_dequantized_bf16=bool(torch.equal(logits, ref_logits)),
         prefill_logits_max_abs_err=err_prefill, decode_logits_max_abs_err=err_step,
         ref_logits_max_abs=scale, logit_rtol=LOGIT_RTOL,
         top1_agree=(logits.argmax(-1) == p_logits.argmax(-1)).float().mean().item())
    if not held < bf16_line["weight_bytes"] or not peak_gb < bf16_line["peak_mem_gb"]:
        raise AssertionError(f"int{bits}: {held} weight bytes and {peak_gb} GB peak against "
                             f"the bf16 phase's {bf16_line['weight_bytes']} and "
                             f"{bf16_line['peak_mem_gb']}")
    del engine, model, ref, ref_model, plain, loop, cache, dense, quantized
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
    """Coarse owner of a device kernel, by its name: the port's attention
    kernels, the convolutions (cuDNN, their layout transforms included),
    cuBLAS products, the group norms' statistics, the other torch kernels."""
    if re.search(r"flash_fwd_|flash_bwd_|decode_|sparse_fwd_|sparse_bwd_", name):
        return "port attention kernels"
    if re.search(r"fprop|dgrad|conv|cudnn|implicit|nchwToNhwc|nhwcToNchw", name, re.I):
        return "convolutions (cuDNN)"
    if re.search(r"gemm|nvjet|cutlass|xmma|cublas|splitK", name, re.I):
        return "matmul (cuBLAS)"
    if re.search(r"Moments|GroupNorm|ComputeFusedParams", name):
        return "norms (statistics)"
    if "at::native" in name or "Memcpy" in name or "Memset" in name:
        return "torch elementwise, reduction, copy"
    return "other"


def device_profile(fn, top: int = 6, count: str = None, ranges: dict = None):
    """Run fn() under torch.profiler: host wall ms, device ms summed over
    kernels, the device's idle share of the wall time, device ms by kernel
    category, the device kernels run, the top kernels, the number of host-to-device copies and of
    CUDA graph launches; with ``count``, the number of device kernels whose
    name matches it; with ``ranges`` ({label: regex}), the device ms of the
    kernels run under the host events (profiler ranges, autograd nodes)
    whose name matches each regex. The profiler's own overhead lengthens
    the wall time."""
    from torch.profiler import ProfilerActivity, profile

    annotation = lambda e: getattr(e, "is_user_annotation", False) or any(
        re.search(rx, e.key) for rx in (ranges or {}).values())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    dev = lambda e: e.self_device_time_total / 1e3     # us → ms
    # kernels only: a profiler range also shows as a device-side annotation
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not annotation(e)),
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
           "kernels": sum(e.count for e in rows),
           "top": [[e.key[:70], dev(e), e.count] for e in rows[:top]], "htod_copies": htod,
           "memcpy_ms": memcpy_ms,
           "graph_launches": graphs, "graph_events": graph_keys}
    if count:
        out["kernels_matching"] = {count: sum(e.count for e in rows if re.search(count, e.key))}
    if ranges:
        host = [e for e in prof.key_averages() if e.device_type != DeviceType.CUDA]
        out["by_range"] = {label: sum(e.device_time_total / 1e3 for e in host
                                      if re.search(rx, e.key))
                           for label, rx in ranges.items()}
    return out


def _replays_profile(model, loop, ids):
    """PROFILE_STEPS replays of the captured decode step, from a fresh
    prefill of ``ids`` into the loop's buffers, under the profiler."""
    logits, cache = model.prefill(ids, loop.cache)
    loop.load(logits, cache, 0)
    return device_profile(lambda: [loop.graph.replay() for _ in range(PROFILE_STEPS)],
                          count=r"decode_split_")


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

    prefill = device_profile(lambda: model.prefill(ids, model.init_cache(BATCH, PROMPT + GEN)))
    graphed = _replays_profile(model, loop, ids)
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
    """One loss and its gradients, by name; a weight the loss does not use
    (a MoE model's odd-block MLP) has none and is left out."""
    model.zero_grad(set_to_none=True)
    loss = model.loss(batch)
    loss.backward()
    return loss.detach().float(), {n: p.grad.float() for n, p in model.named_parameters()
                                   if p.grad is not None}


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


def _timed_steps(engine, batch, accel, kernels, warmup=TRAIN_WARMUP, steps=TRAIN_STEPS):
    """``warmup`` steps, then the counts of ``kernels`` set to 0 and
    ``steps`` timed steps. → (losses, step ms each, peak GB)."""
    losses = [float(engine.train_batch(batch)) for _ in range(warmup)]
    torch.cuda.synchronize()
    accel.reset_peak_memory_stats()
    for kern in kernels:
        kern.reset_launches()
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))   # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not falling: {losses}")
    return losses, step_ms, accel.max_memory_allocated() / 1e9


def _train_line(c, batch, seq, step_ms, accel, dtype=torch.bfloat16, warmup=TRAIN_WARMUP):
    step_s = sorted(step_ms)[len(step_ms) // 2] / 1e3             # the median step
    tokens = batch * seq
    flops = c.flops_per_token(seq) * tokens
    return dict(batch=batch, seq=seq, gas=1, dtype=str(dtype).split(".")[-1],
                params=c.num_params(),
                warmup_steps=warmup, timed_steps=len(step_ms), step_ms=step_s * 1e3,
                step_ms_each=step_ms, tokens_per_s=tokens / step_s,
                mfu=flops / step_s / accel.peak_flops(dtype),
                model_tflop_per_step=flops / 1e12)


def train_slice(initialize, GPT2Model, cfg, accel, fa):
    """gpt2-760m, bf16, full width and depth, through initialize →
    train_batch: the counted main-path run of the dense training slice.
    → (launches, batch, the timed run's losses, those and the losses of
    the further steps the armed resilience cell takes, untimed and
    uncounted)."""
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
    extended = losses + [float(engine.train_batch(batch)) for _ in range(
        RESILIENCE_WARMUP + RESILIENCE_STEPS - len(losses))]
    emit(f"train {TRAIN_MODEL}", **_train_line(c, TRAIN_BATCH, TRAIN_SEQ, step_ms, accel),
         peak_mem_gb=peak_gb, losses=losses,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         grad_norm=engine.get_global_grad_norm(), lr=engine.get_lr()[0])
    emit(f"profile train {TRAIN_MODEL}",
         step=device_profile(lambda: engine.train_batch(batch), top=12))
    del engine
    torch.cuda.empty_cache()
    return launches, batch, losses, extended


def _hand_checkpointed_loss(model, batch, checkpointing, policy=None):
    """GPT-2's loss with ``checkpointing.checkpoint`` around each block in a
    loop written here (the reference's Megatron-style use of the module),
    under ``policy`` (None: the configured one)."""
    ids = batch["input_ids"]
    x = model._embed(ids)
    rope = model._rope_tables(torch.arange(ids.shape[1], device=x.device))
    for n, blk in enumerate(model.blocks):
        x = checkpointing.checkpoint(lambda h, blk=blk, n=n: model._block(h, blk, n, rope), x,
                                     policy=policy)
    with model._gathered(model) as top:
        return model.loss_stage(top, x, batch)


def train_activation_checkpointing(initialize, GPT2Model, cfg, accel, fa, ref_losses, batch):
    """gpt2-760m's training phase with the DeepSpeed-Chat
    ``activation_checkpointing`` block (and ``memory_breakdown`` and
    ``dump_state``): its losses must be the plain phase's bit for bit (the
    block asks for nothing a one-card run changes). Then a loop written
    here calls ``checkpointing.checkpoint`` around each block of the port's
    ``GPT2Model`` (bf16, 8 x 1024), with ``cpu_checkpointing`` off and then
    on: step ms (forward and backward) and peak memory of each; the
    gradients held to the model's own ``remat="full"`` loss at the bf16
    limit (AC_GRAD_RTOL, relative L2); with ``cpu_checkpointing`` the kept
    matmul outputs are pinned host tensors.
    → the engine run's launches."""
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing

    c = dataclasses.replace(cfg, remat=False)
    label = f"train {TRAIN_MODEL} activation_checkpointing"
    steps = TRAIN_WARMUP + TRAIN_STEPS
    config = {**TRAIN_CONFIG, "activation_checkpointing": dict(AC_BLOCK),
              "memory_breakdown": True, "dump_state": True, "steps_per_print": steps}
    engine, *_ = initialize(model=GPT2Model(c), config=config)
    losses, step_ms, peak_gb = _timed_steps(engine, batch, accel, (fa.KERNEL, fa.BWD_KERNEL))
    launches = {"flash_attention_fwd": fa.KERNEL.launches, **fa.BWD_KERNEL.entry_launches}
    expect = dict.fromkeys(launches, c.n_layer * TRAIN_STEPS)
    if launches != expect or losses != ref_losses:
        raise AssertionError(f"{label}: launches {launches} (expected {expect}), losses "
                             f"{losses} against the plain phase's {ref_losses}")
    emit(label, **_train_line(c, TRAIN_BATCH, TRAIN_SEQ, step_ms, accel),
         activation_checkpointing=AC_BLOCK, memory_breakdown=True, dump_state=True,
         configured=checkpointing.is_configured(), peak_mem_gb=peak_gb, losses=losses,
         losses_bitwise_equal_to_plain_phase=True,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()})
    del engine
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = GPT2Model(c).init_params(gen).to(torch.bfloat16)
    full = GPT2Model(dataclasses.replace(c, remat="full"))
    full.load_state_dict(model.state_dict(), assign=True)
    _, want = _grads(full, batch)
    del full
    runs = {}
    for cpu in (False, True):
        checkpointing.configure(checkpoint_in_cpu=cpu)
        times = []
        for step in range(1 + AC_STEPS):
            model.zero_grad(set_to_none=True)
            if step == 1:
                torch.cuda.synchronize()
                accel.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = _hand_checkpointed_loss(model, batch, checkpointing)
            loss.backward()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        got = {n: p.grad.float() for n, p in model.named_parameters() if p.grad is not None}
        rel = {n: _rel_l2(got[n], want[n]) for n in want}
        worst = max(rel, key=rel.get)
        runs["cpu_checkpointing" if cpu else "recompute"] = dict(
            loss=loss.item(), step_ms=sorted(times[1:])[AC_STEPS // 2], step_ms_each=times[1:],
            peak_mem_gb=accel.max_memory_allocated() / 1e9, grad_rel_l2_max=rel[worst],
            grad_rel_l2_worst=worst, grads_bitwise_equal_to_remat_full=all(
                torch.equal(got[n], want[n]) for n in want))
        if set(got) != set(want) or rel[worst] > AC_GRAD_RTOL:
            raise AssertionError(f"{label} hand loop (cpu_checkpointing={cpu}): grad {worst} "
                                 f"rel {rel[worst]} against remat full")
    # where cpu_checkpointing keeps a block's matmul outputs
    store = []
    x = model._embed(batch["input_ids"]).detach().requires_grad_()
    rope = model._rope_tables(torch.arange(TRAIN_SEQ, device="cuda"))
    out = torch.utils.checkpoint.checkpoint(
        lambda h: model._block(h, model.blocks[0], 0, rope), x, use_reentrant=False,
        context_fn=lambda: checkpointing.offload_contexts(store))
    if not store or not all(t.device.type == "cpu" and t.is_pinned() for t in store):
        raise AssertionError(f"{label}: the kept matmul outputs are not pinned host tensors")
    kept = {"tensors_per_block": len(store),
            "bytes_per_block": sum(t.numel() * t.element_size() for t in store)}
    checkpointing.configure()
    emit(f"{label} hand loop", batch=TRAIN_BATCH, seq=TRAIN_SEQ, layers=c.n_layer,
         timed_steps=AC_STEPS, step="forward and backward, no optimizer", **runs,
         host_kept=kept, grad_rtol=AC_GRAD_RTOL)
    del model, want, got, out, store
    torch.cuda.empty_cache()
    return launches


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


def _pin_routing(model, routes) -> None:
    """Each MoE layer of ``model`` routes as ``routes`` (another path's
    recorded routing; ``MOELayer.pinned``)."""
    for layer, r in zip(model.moe, routes):
        layer.moe_layer.pinned = r


def train_check_bf16(GPT2Model, cfg, batch, label, to_plain):
    """One bf16 step's loss and every gradient, kernel path against plain
    path (``to_plain`` swaps the model's attention) on the same weights and
    batch. A MoE model's plain path is held with its routing pinned to the
    kernel path's (``_pin_routing``): top-k routing is discontinuous, and a
    token the two paths' bf16 roundings send to other experts moves the
    gate's gradient by far more than the kernels do; the share of such
    tokens and the unpinned gradients' differences are reported."""
    model = GPT2Model(cfg).init_params(torch.Generator(device="cuda").manual_seed(SEED))
    model.to(dtype=torch.bfloat16)
    moe = [layer.moe_layer for layer in getattr(model, "moe", ())]
    for layer in moe:
        layer.record = True
    loss_k, grads_k = _grads(model, batch)
    routes = [layer.routing for layer in moe]
    to_plain(model)
    loss_p, grads_p = _grads(model, batch)
    routing = {}
    if moe:
        # the share of tokens the two paths' bf16 roundings send elsewhere,
        # the unpinned differences, then the plain path on the kernel
        # path's routing
        other = [(r["experts"] != layer.routing["experts"]).float().mean().item()
                 for r, layer in zip(routes, moe)]
        free = {n: _rel_l2(grads_k[n], grads_p[n]) for n in grads_k}
        worst_free = max(free, key=free.get)
        routing = {"routed_differently_share": sum(other) / len(other),
                   "routed_differently_by_layer": other,
                   "unpinned_loss_rel_diff": abs(loss_k.item() - loss_p.item()) / abs(
                       loss_p.item()),
                   "unpinned_grad_rel_l2_max": free[worst_free],
                   "unpinned_grad_rel_l2_worst": worst_free, "routing_pinned": True}
        for layer in moe:
            layer.record = False
        _pin_routing(model, routes)
        loss_p, grads_p = _grads(model, batch)
    rel = {n: _rel_l2(grads_k[n], grads_p[n]) for n in grads_k}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    finite = all(torch.isfinite(g).all().item() for g in grads_k.values())
    emit(f"train check {label} bf16", layers=cfg.n_layer, remat=cfg.remat,
         loss_kernel=loss_k.item(), loss_plain=loss_p.item(), loss_rel_diff=loss_rel,
         loss_rtol=TRAIN_LOSS_RTOL, grad_rel_l2_max=rel[worst], grad_rel_l2_worst=worst,
         grad_rel_l2_median=sorted(rel.values())[len(rel) // 2], grad_rtol=TRAIN_GRAD_RTOL,
         **routing)
    if not finite or loss_rel > TRAIN_LOSS_RTOL or rel[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError(f"bf16 kernel path vs plain path: loss rel {loss_rel}, "
                             f"grad {worst} rel {rel[worst]}")
    del model, grads_k, grads_p
    torch.cuda.empty_cache()


def _fp32_runs(initialize, GPT2Model, cfg, seq, paths, make_batch=None, remat=False):
    """fp32, full width, 2 layers, B=2, gas=2: three AdamW steps through the
    engine for each of ``paths`` ({name: (extra config, the model's swap to
    the plain path or None)}) from the same weights and batch under
    ``remat``; ``make_batch(rows, seq, vocab, seed, device)`` makes the
    batch (token rows by default). → {name: (losses, trained params by
    name)} on the card, the params read whole through ``module_state_dict``
    (a stage-3 engine's own parameters are empty)."""
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    make_batch = make_batch or synthetic_lm_batch
    k = CHECK_FP32
    c = dataclasses.replace(cfg, n_layer=k["layers"], remat=remat, dtype=torch.float32)
    init = GPT2Model(c).init_params(torch.Generator(device="cuda").manual_seed(SEED + 1))
    config = {"train_batch_size": k["batch"] * k["gas"], "gradient_accumulation_steps": k["gas"],
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}},
              "gradient_clipping": 1.0, "steps_per_print": 0}
    batch = make_batch(k["batch"] * k["gas"], seq, c.vocab_size, seed=SEED + 1, device="cuda")
    runs = {}
    for name, (extra_config, to_plain) in paths.items():
        model = GPT2Model(c)
        if to_plain is not None:
            to_plain(model)
        engine, *_ = initialize(model=model, config={**config, **extra_config},
                                model_parameters={n: t.clone()
                                                  for n, t in init.state_dict().items()})
        losses = [float(engine.train_batch(batch)) for _ in range(k["steps"])]
        sd = engine.module_state_dict()
        params = {n: sd[n].to("cuda") for n, _ in model.named_parameters()}
        empty = [n for n, t in params.items() if not t.numel()]
        if empty or not params:
            raise AssertionError(f"fp32 check {name}: no values read for {empty or 'any param'}")
        runs[name] = (losses, params)
        del engine, model, sd
        gc.collect()
    torch.cuda.empty_cache()
    return runs


def _fp32_compare(runs, a, b) -> dict:
    """Run ``a`` against run ``b`` of :func:`_fp32_runs`: the largest
    relative loss difference, the params' relative L2 (all, and the worst
    tensor's) and whether both are equal bit for bit."""
    (la, pa), (lb, pb) = runs[a], runs[b]
    flat = lambda ps: torch.cat([t.flatten() for t in ps.values()])
    rel = {n: _rel_l2(pa[n], pb[n]) for n in pa}
    worst = max(rel, key=rel.get)
    return {"loss_rel_diff": max(abs(x - y) / abs(y) for x, y in zip(la, lb)),
            "param_rel_l2": _rel_l2(flat(pa), flat(pb)), "per_tensor_rel_l2_max": rel[worst],
            "per_tensor_rel_l2_worst": worst, "params_compared": len(pa),
            "bitwise_equal": la == lb and all(torch.equal(pa[n], pb[n]) for n in pa)}


def train_check_fp32(initialize, GPT2Model, cfg, label, seq, extra_config, to_plain,
                     make_batch=None, remat=False):
    """The engine's fp32 steps (:func:`_fp32_runs`) on the kernel path and
    the plain path (``to_plain`` swaps the model's attention before the
    engine is built): losses and params within FP32_RTOL."""
    k = CHECK_FP32
    runs = _fp32_runs(initialize, GPT2Model, cfg, seq,
                      {"kernel": (extra_config, None), "plain": (extra_config, to_plain)},
                      make_batch, remat)
    got = _fp32_compare(runs, "kernel", "plain")
    emit(f"train check {label} fp32 {k['layers']}-layer", seq=seq, **k, remat=remat,
         losses_kernel=runs["kernel"][0], losses_plain=runs["plain"][0], **got, rtol=FP32_RTOL)
    if got["loss_rel_diff"] > FP32_RTOL or got["param_rel_l2"] > FP32_RTOL:
        raise AssertionError(f"fp32 kernel path vs plain path: loss rel {got['loss_rel_diff']}, "
                             f"params rel {got['param_rel_l2']}")
    del runs
    gc.collect()
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
    """The engine's fp32 steps (:func:`_fp32_runs`) at ZeRO stage 3 against
    stage 0 on the same weights and batch, held as train_check_fp32 holds
    the kernel path to the plain path."""
    k = CHECK_FP32
    runs = _fp32_runs(initialize, GPT2Model, cfg, TRAIN_SEQ,
                      {s: ({"zero_optimization": {"stage": s}}, None) for s in (0, 3)})
    got = _fp32_compare(runs, 3, 0)
    emit(f"train check {TRAIN_MODEL} zero3 fp32 {k['layers']}-layer", **k, seq=TRAIN_SEQ,
         losses_stage0=runs[0][0], losses_stage3=runs[3][0], **got, rtol=FP32_RTOL)
    if got["loss_rel_diff"] > FP32_RTOL or got["param_rel_l2"] > FP32_RTOL:
        raise AssertionError(f"fp32 stage 3 vs stage 0: loss rel {got['loss_rel_diff']}, "
                             f"params rel {got['param_rel_l2']}")
    del runs
    gc.collect()
    torch.cuda.empty_cache()


def zero_slice(initialize, GPT2Model, cfg, accel, fa):
    """gpt2-760m, bf16 with fp32 masters, full width and depth, through
    initialize → train_batch over a NCCL process group of one (every
    collective of the stage runs), at ZeRO stages 0-3: each stage's steps,
    collectives per step (CommsLogger, on one extra step), stage-3 gathers,
    peak memory and kernel launches; the losses held to stage 0's. →
    (launches, losses and median step ms, each by stage)."""
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
        losses, launches, step_med = {}, {}, {}
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
            step_med[stage] = sorted(step_ms)[TRAIN_STEPS // 2]
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
            if stage == 3:
                # the gathers' share of the step: the other stages' profiles
                # are the plain cell's
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
    return launches, losses, step_med


# ------------------------------------------------------- launch and serve
# the user's script of the launch phase: written into the run's scratch
# directory and started by the port's launcher, one process per GPU
LAUNCHED_SCRIPT = """\
import argparse, dataclasses, json, os, time

import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models.gpt2 import PRESETS, GPT2Model, synthetic_lm_batch
from deepspeed_tpu_torch.ops.pallas import flash_attention as fa

parser = argparse.ArgumentParser()
deepspeed_tpu_torch.add_config_arguments(parser)
for name in ("model", "prefix"):
    parser.add_argument("--" + name)
for name in ("batch", "seq", "warmup", "steps", "seed"):
    parser.add_argument("--" + name, type=int)
args = parser.parse_args()
deepspeed_tpu_torch.get_accelerator().set_device(int(os.environ["LOCAL_RANK"]))
cfg = dataclasses.replace(PRESETS[args.model], remat=False)
engine, *_ = deepspeed_tpu_torch.initialize(args=args, model=GPT2Model(cfg))
batch = synthetic_lm_batch(args.batch, args.seq, cfg.vocab_size, seed=args.seed, device="cuda")
losses = [float(engine.train_batch(batch)) for _ in range(args.warmup)]
fa.KERNEL.reset_launches()
fa.BWD_KERNEL.reset_launches()
step_ms = []
for _ in range(args.steps):
    t0 = time.perf_counter()
    losses.append(float(engine.train_batch(batch)))
    step_ms.append((time.perf_counter() - t0) * 1e3)
launches = {"flash_attention_fwd": fa.KERNEL.launches, **fa.BWD_KERNEL.entry_launches}
seen = {k: os.environ.get(k) for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE",
                                      "CUDA_VISIBLE_DEVICES", "MASTER_ADDR", "MASTER_PORT")}
deepspeed_tpu_torch.telemetry.deconfigure()     # the trace to disk
print(args.prefix + json.dumps({
    "env": seen, "backend": comm.get_backend(), "world": comm.get_world_size(),
    "device": str(engine.device), "losses": losses, "step_ms_each": step_ms,
    "launches": launches, "goodput_armed": engine._goodput is not None,
    "build_seconds": {k.name: k.build_seconds for k in (fa.KERNEL, fa.BWD_KERNEL)},
    "load_seconds": {k.name: k.load_seconds for k in (fa.KERNEL, fa.BWD_KERNEL)},
    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)
comm.destroy_process_group()
"""
LAUNCHED_PREFIX = "launched run: "
LAUNCH_TIMEOUT_S = 400


def _run_launcher(cmd, env, timeout: float):
    """Run the launcher in a session of its own: (exit code, stdout,
    stderr, seconds). On the timeout its whole group gets SIGTERM (its
    launch.py forwards it to the children), then SIGKILL, and this
    raises."""
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            out, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
        raise AssertionError(f"the launched run did not end in {timeout} s:\n{out[-4000:]}\n"
                             f"{err[-4000:]}")
    return proc.returncode, out, err, time.perf_counter() - t0


def launch_slice(cfg, zero1_losses, zero1_step_ms, tmp):
    """The dense training cell's recipe (ZeRO stage 1, bf16, 8 x 1024) with
    ``telemetry`` and ``goodput`` started from the command line: ``python -m
    deepspeed_tpu_torch.launcher.runner --num_gpus 1`` runs a user script
    (``add_config_arguments``, ``set_device(LOCAL_RANK)``, ``initialize``
    joining a NCCL group of one from the launcher's environment), which
    takes TRAIN_WARMUP and TRAIN_STEPS steps. Held: exit 0, the environment
    it saw, 24 launches of K1 and of each K2 entry per step, and its losses
    within TRAIN_LOSS_RTOL of the in-process stage-1 run on the same batch;
    its first step's goodput ``compile`` bucket holds at least 0.9 of the
    kernels' ``nvcc`` build seconds in that process, or, the libraries
    found built, of their load seconds. It saves no tag: ``serve
    gpt2-760m`` serves the resume phase's. → its launches."""
    from deepspeed_tpu_torch.goodput.ledger import step_ledgers
    from deepspeed_tpu_torch.profiling.aggregate import load_trace_events

    script = os.path.join(tmp, "train_gpt2.py")
    with open(script, "w") as f:
        f.write(LAUNCHED_SCRIPT)
    ds_config = os.path.join(tmp, "ds_config.json")
    tel = os.path.join(tmp, "telemetry")
    with open(ds_config, "w") as f:
        json.dump({**TRAIN_CONFIG, "goodput": {},
                   "telemetry": {"enabled": True, "output_dir": tel, "flush_interval": 1000}}, f)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p)}
    cmd = [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner", "--num_gpus", "1",
           "--master_port", str(_free_port()), script, "--deepspeed_config", ds_config,
           "--model", TRAIN_MODEL, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
           "--warmup", str(TRAIN_WARMUP), "--steps", str(TRAIN_STEPS), "--seed", str(SEED),
           "--prefix", LAUNCHED_PREFIX]
    rc, out, err, wall_s = _run_launcher(cmd, env, LAUNCH_TIMEOUT_S)
    lines = [ln for ln in out.splitlines() if ln.startswith(LAUNCHED_PREFIX)]
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"the launched run exited {rc} with {len(lines)} result lines:\n"
                             f"{out[-4000:]}\n{err[-4000:]}")
    got = json.loads(lines[0][len(LAUNCHED_PREFIX):])
    env_seen = got["env"]
    if {k: env_seen[k] for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "CUDA_VISIBLE_DEVICES")} \
            != {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1", "CUDA_VISIBLE_DEVICES": "0"} \
            or got["backend"] != "nccl" or got["world"] != 1:
        raise AssertionError(f"the launched process saw {env_seen}, {got['backend']} of "
                             f"{got['world']}")
    n_layer = cfg.n_layer
    expect = dict.fromkeys(got["launches"], n_layer * TRAIN_STEPS)
    if got["launches"] != expect or len(expect) != 3:
        raise AssertionError(f"launched run: launch counts {got['launches']} over "
                             f"{TRAIN_STEPS} steps, expected {expect}")
    losses = got["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, zero1_losses))
    if len(losses) != len(zero1_losses) or not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"launched losses {losses} against the in-process stage-1 run's "
                             f"{zero1_losses}: rel {rel}")
    step_ms = sorted(got["step_ms_each"])[TRAIN_STEPS // 2]
    # the compile bucket: the step whose window holds the process's first
    # kernel loads holds their nvcc builds, or, where the libraries were
    # already built, their loads
    events, _ = load_trace_events(os.path.join(tel, "trace.json"))
    ledgers = step_ledgers(events)
    built = {k: v for k, v in got["build_seconds"].items() if v}
    phase = "nvcc" if built else "load"
    seconds = sum((built or got["load_seconds"]).values())
    first = ledgers[0]["buckets"] if ledgers else {}
    compile_spans = [(e["args"]["phase"], e["dur"]) for e in events if e.get("cat") == "compile"]
    emit(f"launch {TRAIN_MODEL}", cmd=" ".join(cmd[1:4] + ["..."]), exit_code=rc,
         goodput_armed=got["goodput_armed"], compile_phase_checked=phase,
         compile_seconds_checked=seconds, build_seconds=got["build_seconds"],
         load_seconds=got["load_seconds"], compile_spans=compile_spans,
         step0_compile_us=first.get("compile"), step0_wall_us=ledgers[0]["wall_us"]
         if ledgers else None, step0_buckets_us={b: v for b, v in first.items() if v > 0},
         env=env_seen, backend=got["backend"], world=got["world"], device=got["device"],
         losses=losses, losses_in_process_zero1=zero1_losses, loss_rel_diff=rel,
         losses_bitwise_equal=losses == zero1_losses, rtol=TRAIN_LOSS_RTOL,
         step_ms=step_ms, step_ms_each=got["step_ms_each"],
         step_ms_in_process_zero1=zero1_step_ms,
         launches_per_step={k: v / TRAIN_STEPS for k, v in got["launches"].items()},
         peak_mem_gb=got["peak_mem_gb"], wall_s=wall_s)
    if not got["goodput_armed"] or len(ledgers) != TRAIN_WARMUP + TRAIN_STEPS \
            or not seconds or first.get("compile", 0.0) < 0.9 * seconds * 1e6:
        raise AssertionError(f"launched run: step 0's compile bucket {first.get('compile')} us "
                             f"against {seconds} s of {phase}, {len(ledgers)} step ledgers")
    return got["launches"]


def serve_tag_slice(init_inference, model_cls, cfg, accel, fa, da, save_dir, label):
    """A training tag served through ``init_inference(config={"checkpoint":
    save_dir})``, bf16, with the decode kernel (gpt2-760m from the launched
    run's tag, llama3.2-1b from its stage-1 run's): the served params equal
    the tag's bit for bit; the counted graphed ``generate`` (B=32, prompt
    128, 128 new, greedy; one K1 per layer per prefill, one K3 per layer
    per decode step) gives the ungraphed loop's tokens; prefill and one
    decode step agree with the plain path on the same weights within
    LOGIT_RTOL of the largest logit."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import read_state, unstack_layers

    c = dataclasses.replace(cfg, use_flash_decode=True, remat=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = init_inference(model_cls(c), config={"checkpoint": save_dir, "dtype": "bfloat16",
                                                   "max_out_tokens": PROMPT + GEN})
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    with open(os.path.join(save_dir, "latest")) as f:
        tag_dir = os.path.join(save_dir, f.read().strip())
    # a MoE tag holds its layers stacked, as the JAX tree
    tag = unstack_layers(read_state(tag_dir, ("params",), "cpu"), engine.module)
    model = engine.module
    served = dict(model.named_parameters())
    if set(tag) != {f"params/{n}" for n in served} or not all(
            torch.equal(p.cpu(), tag[f"params/{n}"].to(torch.bfloat16))
            for n, p in served.items()):
        raise AssertionError("the served params differ from the tag's")
    tag_dtypes = sorted({str(t.dtype) for t in tag.values()})
    del tag
    model_gb = sum(p.numel() * p.element_size() for p in served.values()) / 1e9

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ids = torch.randint(0, c.vocab_size, (BATCH, PROMPT), generator=gen, device="cuda")
    launches, loop, _, _ = _served_cell(engine, ids, accel, fa, da, label,
                                        checkpoint=save_dir, tag_params_dtypes=tag_dtypes,
                                        params_bitwise_equal_to_tag=True, model_gb=model_gb,
                                        load_s=load_s)
    # where a prefill and a graphed decode step spend the device's time
    with torch.inference_mode():
        emit(f"profile {label}", decode_steps=PROFILE_STEPS,
             prefill=device_profile(lambda: model.prefill(ids, model.init_cache(
                 BATCH, PROMPT + GEN))),
             decode_graphed=_replays_profile(model, loop, ids))
    del engine, model, served, loop
    torch.cuda.empty_cache()
    return launches


def launch_slices(cfg, zero1_losses, zero1_step_ms):
    """Launch and train (``launch_slice``) with the user's script in a
    temporary directory on the disk with the most room, removed
    afterwards. → the launched run's launches."""
    root, _ = _scratch_dir()
    tmp = tempfile.mkdtemp(prefix="ds_launch_", dir=root)
    t0 = time.perf_counter()
    try:
        launched = launch_slice(cfg, zero1_losses, zero1_step_ms, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(f"launch {TRAIN_MODEL} seconds", seconds=time.perf_counter() - t0)
    return launched


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


def _disk_rates(tmp: str, gib: float = 2) -> dict:
    """What the disk gives without the checkpoint engine: ``gib`` GiB
    written in 64 MiB chunks and fsynced, then read back after the pages
    were dropped from the page cache, in GB/s."""
    path, chunk = os.path.join(tmp, "disk_probe"), np.ones(64 * 2**20, np.uint8)
    n = int(gib * 16)
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


def data_and_checkpoint_slices(initialize, init_inference, GPT2Model, cfg, accel, fa, da):
    """The resume, curriculum and ladder phases over one token dataset in a
    temporary directory on the disk with the most room, removed afterwards,
    and ``serve gpt2-760m``: the resume phase's tag served
    (``serve_tag_slice``). The resume phase runs ``RESUME_LAYERS`` layers,
    fewer where no candidate holds DISK_MARGIN times the tag (the most
    layers that fit). → (resume, curriculum, serving launches)."""
    need = lambda n: STATE_BYTES_PER_PARAM * dataclasses.replace(cfg, n_layer=n).num_params()
    root, free = _scratch_dir()
    layers = min(cfg.n_layer, RESUME_LAYERS)
    while layers > 2 and DISK_MARGIN * need(layers) > free[root]:
        layers -= 1
    tmp = tempfile.mkdtemp(prefix="ds_resume_", dir=root)
    try:
        emit("disk", free_bytes=free, chosen=root, tag_bytes_predicted=need(layers),
             layers=layers, depth_cut=layers != cfg.n_layer, **_disk_rates(tmp))
        dataset = _token_dataset(tmp, cfg.vocab_size)
        c = dataclasses.replace(cfg, n_layer=layers)
        resume = resume_slice(initialize, GPT2Model, c, accel, fa, dataset, tmp)
        served = serve_tag_slice(init_inference, GPT2Model, c, accel, fa, da,
                                 os.path.join(tmp, "ckpt"), f"serve {TRAIN_MODEL}")
        curriculum = curriculum_slice(initialize, GPT2Model, cfg, fa, dataset)
        resume_ladder(initialize, GPT2Model, cfg, dataset, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return resume, curriculum, served


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


def _offload_row(engine, c, batch, step_ms, prof, accel, warmup=TRAIN_WARMUP) -> dict:
    """A training line with the host link's bytes and rates: bytes of the
    last update each way, their GB/s over the profiled step's copy time,
    and the step split into copy and compute device time."""
    off = engine._offload
    h2d, d2h = (off.h2d_bytes, off.d2h_bytes) if off is not None else (0, 0)
    copy = prof["memcpy_ms"]
    compute_ms = prof["device_ms"] - copy["HtoD"] - copy["DtoH"]
    return dict(_train_line(c, OFFLOAD_BATCH, OFFLOAD_SEQ, step_ms, accel, warmup=warmup),
                remat=c.remat,
                layers=c.n_layer, h2d_gb_per_step=h2d / 1e9, d2h_gb_per_step=d2h / 1e9,
                h2d_gb_per_s=h2d / max(copy["HtoD"], 1e-9) / 1e6,
                d2h_gb_per_s=d2h / max(copy["DtoH"], 1e-9) / 1e6,
                profiled_step={"wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
                               "compute_ms": compute_ms, "memcpy_ms": copy,
                               "idle_share": prof["idle_share"],
                               "by_category": prof["by_category"]})


def offload_slice(initialize, GPT2Model, cfg, accel, fa):
    """gpt2-2.7b, full width at OFFLOAD_LAYERS, 4 x 2048, through
    initialize → train_batch:
    (a) no offload, (b) ``offload_optimizer: cpu`` under the auto policy
    (the master stays on the card, the moments stream in whole),
    (b_streamed) the same placement through the streamed update, (c) the
    master on the host, streamed unit by unit, serially, (d) as (c) with
    ``stream_overlap``. Each offloaded run must give (a)'s losses and
    params bit for bit; each run's steps, peaks, host state, host-link bytes and rates and
    a profiled step are reported beside a pinned ``copy_``'s rates."""
    import gc

    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    c = dataclasses.replace(cfg, n_layer=OFFLOAD_LAYERS)
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
    """gpt2-6.7b at full width and CAPACITY_LAYERS, 4 x 2048,
    ``offload_optimizer: cpu`` under the auto policy (the master on the
    host, the update streamed unit by unit), built through zero.Init's path:
    trains with a finite, falling loss through K1/K2. Fails when the host
    cannot hold its fp32 master and moments beside the process
    (/proc/meminfo, printed)."""
    import gc

    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    gc.collect()
    waited = _settle_host_memory()
    mem = _meminfo()
    c = dataclasses.replace(cfg, n_layer=CAPACITY_LAYERS)
    host_need = HOST_BYTES_PER_PARAM * c.num_params()
    emit("host memory", mem_total_gb=mem["MemTotal"] / 1e9, settle_s=waited,
         mem_available_gb=mem["MemAvailable"] / 1e9, margin_gb=HOST_MARGIN / 1e9,
         model=CAPACITY_MODEL, layers=c.n_layer, host_state_gb_needed=host_need / 1e9,
         card_state_gb_without_offload=18 * c.num_params() / 1e9)
    if host_need + HOST_MARGIN > mem["MemAvailable"]:
        raise AssertionError(f"host memory {mem['MemAvailable'] / 1e9:.1f} GB available cannot "
                             f"hold {c.n_layer} layers of {CAPACITY_MODEL}")
    if 18 * c.num_params() <= accel.total_memory():
        raise AssertionError(f"{c.n_layer} layers of {CAPACITY_MODEL} would fit the card")
    batch = synthetic_lm_batch(OFFLOAD_BATCH, OFFLOAD_SEQ, c.vocab_size, seed=SEED,
                               device="cuda")
    engine, init = _offload_engine(initialize, GPT2Model, c,
                                   {"stage": 1, "offload_optimizer": {"device": "cpu"}})
    off = engine._offload
    if not (off.master_host and off.streamed and not off.overlap):
        raise AssertionError(f"{CAPACITY_MODEL}: the auto policy did not put the master on "
                             f"the host and stream the update: {vars(off)}")
    host_gb = _host_state_bytes(engine) / 1e9
    losses, step_ms, peak_gb = _timed_steps(engine, batch, accel, (fa.KERNEL, fa.BWD_KERNEL),
                                            CAPACITY_WARMUP, CAPACITY_STEPS)
    launches = _check_remat_launches(fa, c.n_layer, CAPACITY_STEPS, f"offload {CAPACITY_MODEL}")
    prof = device_profile(lambda: engine.train_batch(batch), top=8)
    emit(f"offload {CAPACITY_MODEL}", **_offload_row(engine, c, batch, step_ms, prof, accel,
                                                     warmup=CAPACITY_WARMUP),
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
    """NVME_MODEL's width at NVME_LAYERS layers, NVME_BATCH x NVME_SEQ, bf16:
    (e) ``offload_optimizer: nvme`` through the engine and (f)
    ``offload_param: nvme`` (the ZeRO-Infinity engine), each from the same
    seed as the engine without offload, whose losses they must give within
    NVME_LOSS_RTOL; the disk's bytes and rates per step."""
    import gc

    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    c = dataclasses.replace(cfg, n_layer=NVME_LAYERS)
    batch = synthetic_lm_batch(NVME_BATCH, NVME_SEQ, c.vocab_size, seed=SEED, device="cuda")
    config = {**NVME_CONFIG, "aio": dict(NVME_AIO)}
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
               "tokens_per_s": NVME_BATCH * NVME_SEQ / sorted(step_s)[len(step_s) // 2]}
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
        emit(f"nvme {NVME_MODEL} {NVME_LAYERS}-layer ({name})", **row,
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
    """fp32, NVME_MODEL's width, 2 layers: (e) and (f) against the engine in
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
    emit(f"nvme check {NVME_MODEL} fp32 {k['layers']}-layer", **k, losses_memory=l0,
         runs=out, rtol=FP32_NVME_RTOL)
    bad = {n: r for n, r in out.items()
           if r["loss_rel_diff"] > FP32_NVME_RTOL or r["param_rel_l2"] > FP32_NVME_RTOL}
    if bad:
        raise AssertionError(f"fp32 NVMe runs against the engine in memory: {bad}")


def resume_offload(initialize, GPT2Model, cfg, tmp):
    """At the NVMe phase's model: (c) (the master on the host, streamed)
    trains a step and saves; an engine without offload, the NVMe
    engine (e) and the ZeRO-Infinity engine (f) load the tag, and the state
    each restores must equal the saved state bit for bit."""
    import gc

    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (flatten_state,
                                                                       wait_for_pending_saves)

    c = dataclasses.replace(cfg, n_layer=NVME_LAYERS)
    batch = synthetic_lm_batch(NVME_BATCH, NVME_SEQ, c.vocab_size, seed=SEED, device="cuda")
    ckpt = os.path.join(tmp, "ckpt")
    src, _ = _offload_engine(initialize, GPT2Model, c, {"stage": 1, "offload_optimizer": {
        "device": "cpu"}}, {"DS_TPU_OFFLOAD_MASTER": "host", "DS_TPU_FORCE_STREAMED_OFFLOAD": "1"},
        config=NVME_CONFIG)
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
                                    config={**NVME_CONFIG, "aio": dict(NVME_AIO)})
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
    emit(f"resume offload {NVME_MODEL} {NVME_LAYERS}-layer", saved_by="(c)",
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
        emit("disk nvme", free_bytes=free, chosen=root, **_disk_rates(tmp, gib=0.25))
        launches["nvme"] = nvme_slice(initialize, GPT2Model, presets[NVME_MODEL], accel, fa,
                                      tmp)
        nvme_check_fp32(initialize, GPT2Model, presets[NVME_MODEL], tmp)
        resume_offload(initialize, GPT2Model, presets[NVME_MODEL], tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ------------------------------------------------------------- resilience
# the armed training cell: the watchdog (a heartbeat file, the step
# agreement every step), the sentinel and the RAM ring, 2 + 8 steps
RESILIENCE_WARMUP, RESILIENCE_STEPS = 2, 8
SNAP_SETTLE_S = 0.5     # after a SIGUSR1 bundle: the second handler's ask has come
RESILIENCE_REWIND = {"ram_interval": 4, "keep": 2}
# the drills, at the resume phase's depth, each under DSElasticAgent, with
# one RAM slot (each engine page-locks its ring's slots when it is built)
DRILL_REWIND = {**RESILIENCE_REWIND, "keep": 1}
DRILL_STEPS = 10                    # the hang drill's run, faulted and not
DRILL_HANG_AT = 7                   # train_step call the hang lands on
DRILL_WATCHDOG = {"enabled": True, "min_step_timeout": 2.0, "startup_timeout": 120.0}
# the spike drill: one batch repeated at SPIKE_LR until its loss is below
# SPIKE_FALL of its first (at most SPIKE_MAX_REPEATS), then SPIKE_FRESH
# fresh batches, the first of which the sentinel must rewind
SPIKE_LR, SPIKE_FALL, SPIKE_MAX_REPEATS, SPIKE_FRESH = 3e-4, 0.8, 40, 4
SPIKE_SENTINEL = {"enabled": True, "patience": 1, "spike_factor": 1.1, "window": 4,
                  "max_rewinds": 2}
DRILL_PREEMPT_AT, DRILL_CHECKPOINT_INTERVAL = 6, 4


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class _PeakRss:
    """The process's resident bytes sampled every 5 ms on a thread while
    the block runs: the peak above the start."""

    def __enter__(self):
        self.start = self.peak = _rss_bytes()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        return self

    def _run(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, _rss_bytes())

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.peak = max(self.peak, _rss_bytes())

    @property
    def above_start(self) -> int:
        return self.peak - self.start


def _kernel_counts(fa) -> dict:
    return {"flash_attention_fwd": fa.KERNEL.launches, **fa.BWD_KERNEL.entry_launches}


def _reset_counts(fa) -> None:
    for kern in (fa.KERNEL, fa.BWD_KERNEL):
        kern.reset_launches()


def _held_bitwise(got, want, label) -> None:
    if got != want:
        raise AssertionError(f"{label}: losses {got} differ from {want}")


def _bundle_summary(path: str) -> dict:
    """An incident bundle's trigger, bytes, budget and files."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    files = sorted(os.listdir(path))
    return {"trigger": manifest["trigger"], "files": files,
            "bytes": sum(os.path.getsize(os.path.join(path, n)) for n in files),
            "budget_bytes": manifest["budget_bytes"], "notes": manifest["notes"]}


def _bundles(base: str) -> list:
    inc = os.path.join(base, "incidents")
    return sorted(os.listdir(inc)) if os.path.isdir(inc) else []


def _incident_report(base: str) -> tuple:
    """``blackbox.incident report`` over ``base``, in this process: the
    report, its text, and its seconds."""
    from deepspeed_tpu_torch.blackbox import incident

    t0 = time.perf_counter()
    text = _port_tool(incident.main, "report", base)["stdout"]
    seconds = time.perf_counter() - t0
    return incident.build_report([base]), text, seconds


def resilience_armed(initialize, GPT2Model, cfg, accel, fa, ref_losses, ref_step_ms, tmp):
    """The training cell, full width and depth, with the watchdog (a
    heartbeat file, the step agreement every step), the sentinel, the RAM
    ring and the flight recorder: each of its losses must equal the unarmed
    run's at the same step bit for bit (``ref_losses``, as many), K1 and
    each K2 entry launch once per layer a step, the recorder sees every
    step and writes no bundle; a forced one (``blackbox.snap``) is written
    within its budget and the incident report over it exits 0 with no
    first cause."""
    from deepspeed_tpu_torch import blackbox
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch
    from deepspeed_tpu_torch.resilience import rewind as rw

    c = dataclasses.replace(cfg, remat=False)
    hb = os.path.join(tmp, "heartbeat")
    bb_dir = os.path.join(tmp, "blackbox")
    config = {**TRAIN_CONFIG,
              "watchdog": {"enabled": True, "heartbeat_file": hb, "consistency_interval": 1},
              "resilience": {"sentinel": {"enabled": True}},
              "rewind": dict(RESILIENCE_REWIND), "blackbox": {"output_dir": bb_dir}}
    engine, *_ = initialize(model=GPT2Model(c), config=config)
    mgr = engine._rewind
    batch = synthetic_lm_batch(TRAIN_BATCH, TRAIN_SEQ, c.vocab_size, seed=SEED, device="cuda")
    losses = [float(engine.train_batch(batch)) for _ in range(RESILIENCE_WARMUP)]
    torch.cuda.synchronize()
    _reset_counts(fa)
    step_ms, mtimes, snaps = [], [os.stat(hb).st_mtime_ns], {}
    for _ in range(RESILIENCE_STEPS):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        mtimes.append(os.stat(hb).st_mtime_ns)
        newest = mgr.newest()
        if newest is not None and newest.step == engine.global_steps:
            snaps[newest.step] = newest.capture_s * 1e3
    launches = _kernel_counts(fa)
    expect = dict.fromkeys(launches, c.n_layer * RESILIENCE_STEPS)
    rec = engine._blackbox
    steps = RESILIENCE_WARMUP + RESILIENCE_STEPS
    recorder = {"steps_seen": rec.steps_seen(), "steps": steps,
                "overhead_us": rec.overhead_us(),
                "overhead_us_per_step": rec.overhead_us() / max(1, rec.steps_seen()),
                "bundles_clean_run": _bundles(bb_dir), "ring": len(rec.ring_snapshot())}
    if rec.steps_seen() != steps or recorder["bundles_clean_run"] or rec.bundles_written:
        raise AssertionError(f"armed cell: recorder {recorder}")
    t0 = time.perf_counter()
    snap_path = blackbox.snap("chip")
    snap_ms = (time.perf_counter() - t0) * 1e3
    report, report_text, report_s = _incident_report(bb_dir)
    recorder.update(snap=_bundle_summary(snap_path), snap_write_ms=snap_ms,
                    incident_report_s=report_s, incident_report=report_text[:4],
                    first_cause=report["first_cause"])
    if _bundles(bb_dir) != [os.path.basename(snap_path)] or report["first_cause"] is not None \
            or recorder["snap"]["bytes"] > recorder["snap"]["budget_bytes"]:
        raise AssertionError(f"armed cell: forced bundle {recorder}")
    held = rw.ram_snapshots()
    ring_bytes = sum(s.nbytes for s in held)
    snap_steps = [s for s in range(RESILIENCE_WARMUP + 1, RESILIENCE_WARMUP + RESILIENCE_STEPS + 1)
                  if s % RESILIENCE_REWIND["ram_interval"] == 0]
    plain = [ms for i, ms in enumerate(step_ms) if RESILIENCE_WARMUP + 1 + i not in snap_steps]
    emit(f"resilience {TRAIN_MODEL}", part="armed training cell", layers=c.n_layer,
         params=c.num_params(), blocks={k: config[k] for k in ("watchdog", "rewind")},
         sentinel=config["resilience"]["sentinel"],
         losses=losses, losses_unarmed=ref_losses,
         step_ms=sorted(step_ms)[RESILIENCE_STEPS // 2], step_ms_each=step_ms,
         step_ms_mean=sum(step_ms) / len(step_ms),
         step_ms_without_snapshot_median=sorted(plain)[len(plain) // 2],
         step_ms_unarmed=ref_step_ms, snapshot_ms=snaps,
         snapshot_gb_per_s={s: ring_bytes / len(held) / (ms / 1e3) / 1e9
                            for s, ms in snaps.items()},
         ring_steps=[s.step for s in held], host_gb_held=ring_bytes / 1e9,
         pinned=all(s.slot.pinned for s in held), reserve_s=mgr.reserve_s,
         reserved_gb=mgr.reserved_bytes / 1e9,
         heartbeat_mtime_ns=mtimes, heartbeat_advanced=all(
             b > a for a, b in zip(mtimes, mtimes[1:])),
         watchdog_deadline_s=engine._watchdog.deadline_s(),
         watchdog_trips=engine._watchdog.trips, sentinel_trips=engine._bad_step_sentinel.trips,
         blackbox=recorder, nvidia_smi=nvidia_smi_line(),
         launches=launches, launches_expected=expect)
    _held_bitwise(losses, list(ref_losses), "armed cell against the unarmed cell")
    if [s.step for s in held] != snap_steps[-RESILIENCE_REWIND["keep"]:] \
            or not all(b > a for a, b in zip(mtimes, mtimes[1:])):
        raise AssertionError(f"armed cell: ring at {[s.step for s in held]} (expected "
                             f"{snap_steps}), heartbeat mtimes {mtimes}")
    if launches != expect:
        raise AssertionError(f"armed cell: launch counts {launches}, expected {expect}")
    engine._watchdog.close()
    blackbox.deconfigure()
    del engine, mgr, held, rec
    rw.clear_ram_snapshots()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------ monitoring and profiling
# the training cell with the monitor, the telemetry fan-out, the memory
# profiler (a census every step) and the flops profiler at the 3rd timed step
PROFILED_STEP = TRAIN_WARMUP + 3
# the flop count on the card against the CPU's: the cell's model at 2 layers
FLOPS_CHECK = dict(layers=2, batch=2, seq=128)


def matmul_flops(c, batch: int, seq: int) -> int:
    """The matmul flops of one GPT-2 training batch as the flops profiler
    counts them (the JAX package's jaxpr walk), remat off and the chunked
    loss recomputed: per token of the trunk 6 x 12·d² a layer (qkv, out,
    fc, fc2: forward and two backward products) and 12·d·T a layer for
    attention (QKᵀ and PV, full square, and their four backward products);
    the tied head 8·V·d per predicted token (forward, its recompute in the
    chunked loss's backward, two backward products) over T − 1 positions."""
    d, n_layer, vocab = c.n_embd, c.n_layer, c.vocab_size
    trunk = batch * seq * (72 * n_layer * d * d + 12 * n_layer * d * seq)
    return trunk + batch * (seq - 1) * 8 * vocab * d


def _flops_profiled(initialize, GPT2Model, c, device: str, batch: int, seq: int):
    """The flops profiler's count (and per-scope counts) of one train_batch
    of ``c`` on ``device``."""
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    config = {**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": batch,
              "flops_profiler": {"enabled": True, "profile_step": 1, "detailed": False}}
    engine, *_ = initialize(model=GPT2Model(c), config=config, device=device)
    engine.train_batch(synthetic_lm_batch(batch, seq, c.vocab_size, seed=SEED, device=device))
    prof = engine.flops_profile
    del engine
    return int(prof.flops), prof.per_scope


class _Logged(logging.Handler):
    """The port logger's warnings while the block runs."""

    def __init__(self):
        super().__init__(level=logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        from deepspeed_tpu_torch.utils.logging import logger

        self._logger = logger
        logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self)


def profiled_slice(initialize, GPT2Model, cfg, accel, fa, ref_losses, ref_step_ms):
    """The training cell, full width and depth, with ``csv_monitor``,
    ``tensorboard`` (a warning where the library is absent),
    ``telemetry.monitor``, ``profiling`` (a census every step) and
    ``flops_profiler`` at PROFILED_STEP: every loss equals the unarmed
    run's bit for bit; K1 and each K2 entry launch once a layer a step; the
    CSV holds one row per step, equal to the losses; the counted flops of
    the batch equal :func:`matmul_flops`, and a 2-layer model's count on
    the card equals its count on the CPU; the census attributes the params,
    masters and moments at 2, 4 and 8 bytes a parameter and its total is the
    allocator's. → launches."""
    import csv

    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    c = dataclasses.replace(cfg, remat=False)
    root, _ = _scratch_dir()
    tmp = tempfile.mkdtemp(prefix="ds_profiled_", dir=root)
    config = {**TRAIN_CONFIG,
              "csv_monitor": {"enabled": True, "output_path": tmp, "job_name": "profiled"},
              "tensorboard": {"enabled": True, "output_path": tmp, "job_name": "profiled"},
              "telemetry": {"enabled": True, "output_dir": os.path.join(tmp, "telemetry"),
                            "monitor": True},
              "profiling": {"sample_interval": 1},
              "flops_profiler": {"enabled": True, "profile_step": PROFILED_STEP,
                                 "top_modules": 3}}
    try:
        # the span peaks read the allocator's lifetime peak, which an earlier
        # phase may have set higher: this phase's own start from its engine
        torch.cuda.reset_peak_memory_stats()
        with _Logged() as logged:
            engine, *_ = initialize(model=GPT2Model(c), config=config)
        mon = engine.monitor
        batch = synthetic_lm_batch(TRAIN_BATCH, TRAIN_SEQ, c.vocab_size, seed=SEED, device="cuda")
        losses = [float(engine.train_batch(batch)) for _ in range(TRAIN_WARMUP)]
        torch.cuda.synchronize()
        _reset_counts(fa)
        step_ms = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = _kernel_counts(fa)
        expect = dict.fromkeys(launches, c.n_layer * TRAIN_STEPS)
        prof = engine.flops_profile
        tput_flops = engine.tput_timer.flops_per_batch
        census = engine.memory_census()
        allocated = torch.cuda.memory_allocated()
        n = c.num_params()
        snap = {(r["name"], tuple(sorted(r["labels"].items()))): r
                for r in telemetry.get_registry().snapshot()}
        span = snap[("profiling/span_peak_bytes", (("span", "train_batch"),))]
        telemetry.deconfigure()
        mon.csv_monitor.close()
        with open(os.path.join(tmp, "profiled", "Train_Samples_train_loss.csv")) as f:
            rows = [(int(a), float(b)) for a, b in list(csv.reader(f))[1:]]
        csv_files = sorted(os.listdir(os.path.join(tmp, "profiled")))
    finally:
        telemetry.deconfigure()
        shutil.rmtree(tmp, ignore_errors=True)
    profile_i = PROFILED_STEP - TRAIN_WARMUP - 1
    others = [ms for i, ms in enumerate(step_ms) if i != profile_i]
    median = sorted(others)[len(others) // 2]
    closed = matmul_flops(c, TRAIN_BATCH, TRAIN_SEQ)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    c2 = dataclasses.replace(c, n_layer=FLOPS_CHECK["layers"])
    shape = (FLOPS_CHECK["batch"], FLOPS_CHECK["seq"])
    small = {dev: _flops_profiled(initialize, GPT2Model, c2, dev, *shape)
             for dev in ("cuda", "cpu")}
    small_closed = matmul_flops(c2, *shape)
    expected_bytes = {"params": 2 * n, "master": 4 * n, "optimizer_state": 8 * n}
    emit(f"profiled {TRAIN_MODEL}", layers=c.n_layer, params=n,
         blocks=sorted(k for k in config if k not in TRAIN_CONFIG),
         tensorboard_enabled=mon.tb_monitor.enabled, warnings_at_init=logged.messages,
         losses=losses, losses_unarmed=list(ref_losses[:len(losses)]),
         step_ms=median, step_ms_each=step_ms, step_ms_unarmed=ref_step_ms,
         profile_step=PROFILED_STEP, profile_step_ms=step_ms[profile_i],
         profile_step_extra_ms=step_ms[profile_i] - median,
         profile_step_device_ms=prof.duration * 1e3,
         counted_flops=int(prof.flops), closed_form_flops=closed,
         counted_tflop=prof.flops / 1e12, model_flops_per_token_tflop=(
             c.flops_per_token(TRAIN_SEQ) * TRAIN_BATCH * TRAIN_SEQ / 1e12),
         per_scope_top={s or "<toplevel>": f for s, f in
                        sorted(prof.per_scope.items(), key=lambda kv: -kv[1])[:3]},
         est_tflops_flops_per_batch=tput_flops,
         achieved_tflop_s_profile_step=prof.flops / prof.duration / 1e12,
         flops_2_layer={"cuda": small["cuda"][0], "cpu": small["cpu"][0],
                        "closed_form": small_closed, "shape": shape},
         census_bytes=census.bucket_bytes, census_total=census.total_bytes,
         memory_allocated=allocated, census_attributed_fraction=census.fraction_attributed,
         expected_state_bytes=expected_bytes,
         span_peak_bytes_train_batch={"max": span["max"], "p50": span["p50"],
                                      "count": span["count"]},
         csv_rows=rows, csv_files=len(csv_files), launches=launches, launches_expected=expect)
    _held_bitwise(losses, list(ref_losses[:len(losses)]), "profiled cell against the unarmed cell")
    if launches != expect:
        raise AssertionError(f"profiled cell: launch counts {launches}, expected {expect}")
    if [v for _, v in rows] != losses or [s for s, _ in rows] != [
            TRAIN_BATCH * (i + 1) for i in range(len(losses))]:
        raise AssertionError(f"profiled cell: the CSV's losses {rows} are not the run's {losses}")
    if int(prof.flops) != closed or tput_flops != prof.flops or small["cuda"] != small["cpu"] \
            or small["cuda"][0] != small_closed:
        raise AssertionError(f"profiled cell: counted {int(prof.flops)} flops against the closed "
                             f"form {closed}; 2 layers: {small['cuda'][0]} on the card, "
                             f"{small['cpu'][0]} on the CPU, closed form {small_closed}")
    if census.total_bytes != allocated or any(census.bucket_bytes[b] != v
                                              for b, v in expected_bytes.items()):
        raise AssertionError(f"profiled cell: census {census.bucket_bytes} (total "
                             f"{census.total_bytes}, allocated {allocated}), expected "
                             f"{expected_bytes}")
    if not mon.tb_monitor.enabled and not any("TensorBoard" in m for m in logged.messages):
        raise AssertionError("profiled cell: the TensorBoard writer is off without its warning")
    if not span["count"] or span["max"] <= 0:
        raise AssertionError(f"profiled cell: no train_batch span peak ({span})")
    return launches


def _drill_agent(initialize, GPT2Model, c, config, save_dir, batches, num_steps,
                 on_step=None, **agent_kw):
    """A DSElasticAgent run of ``num_steps`` over ``batches(agent)`` (one
    batch per engine step), ``on_step(agent)`` after each step: its status,
    every (step, loss) it saw, and each engine's flight recorder."""
    from deepspeed_tpu_torch.elasticity import DSElasticAgent

    seen, recorders = [], []

    def factory():
        engine = initialize(model=GPT2Model(c), config=dict(config))[0]
        recorders.append(engine._blackbox)
        return engine

    def callback(step, loss):
        seen.append((step, float(loss)))
        if on_step is not None:
            on_step(agent)

    agent = DSElasticAgent(factory, save_dir, **{"checkpoint_interval": 0,
                                                 "install_signal_handlers": False, **agent_kw})
    out = agent.run(lambda: batches(agent), num_steps=num_steps, step_callback=callback)
    return agent, out, seen, recorders


def _by_step(seen) -> dict:
    """The last loss seen at each step (a re-trodden step replaces the
    first)."""
    return {step: loss for step, loss in seen}


def _sigusr1_snap(agent, state) -> None:
    """Once the engine after the restart is up: one SIGUSR1 to this
    process, and the wait for the live recorder's bundle."""
    import signal

    from deepspeed_tpu_torch import blackbox

    if agent.restart_count != 1 or "ms" in state:
        return
    rec = blackbox.get_recorder()
    t0 = time.perf_counter()
    os.kill(os.getpid(), signal.SIGUSR1)
    while rec.bundles_written < 1 and time.perf_counter() - t0 < 30.0:
        time.sleep(0.005)
    state["ms"] = (time.perf_counter() - t0) * 1e3
    state["bundle"] = rec.last_bundle_dir
    time.sleep(SNAP_SETTLE_S)           # the agent's chained handler has asked too


def _triggers(base: str) -> list:
    """The triggers of the bundles under ``base`` (``<ts>_<trigger>``)."""
    return sorted(name.split("_", 1)[1] for name in _bundles(base))


def _hang_forensics(recorders, snap, telemetry_dir, restart_record) -> dict:
    """The hang drill's flight-recorder evidence, checked: the ring of the
    engine that hung and of the one after the restart, the two bundles
    (the timeout's and the SIGUSR1's), the main thread in the SIGUSR1
    bundle's stacks, and the incident report over both."""
    if len(recorders) != 2 or None in recorders:
        raise AssertionError(f"hang drill: recorders {recorders}")
    hung, after = recorders
    kinds = [(e["kind"], e["severity"]) for e in hung.ring_snapshot()]
    with open(os.path.join(snap.get("bundle") or "", "stacks.txt")) as f:
        stacks = f.read()
    report, text, report_s = _incident_report(telemetry_dir)
    cause = report["first_cause"] or {}
    recovery = (report.get("cost") or {}).get("recovery") or {}
    out = {"ring_before_restart": kinds, "bundles": _triggers(telemetry_dir),
           "bundles_written": [hung.bundles_written, after.bundles_written],
           "sigusr1_bundle_ms": snap.get("ms"),
           "sigusr1_bundle": _bundle_summary(snap["bundle"]),
           "main_thread_in_stacks": os.path.basename(__file__) in stacks,
           "first_cause": cause, "recovery": recovery, "incident_report_s": report_s,
           "incident_report": [line for line in text if not line.startswith("  ")]}
    order = [k for k in kinds if k in (("chaos_injection", "warning"),
                                       ("watchdog_timeout", "error"), ("restart", "error"))]
    if order != [("chaos_injection", "warning"), ("watchdog_timeout", "error"),
                 ("restart", "error")] or hung.last_trigger != "watchdog_timeout" \
            or out["bundles"] != ["sigusr1", "watchdog_timeout"] \
            or out["bundles_written"] != [1, 1] or not out["main_thread_in_stacks"] \
            or cause.get("kind") != "watchdog_timeout" \
            or cause.get("step") != restart_record.get("step") or recovery.get("tier") != "ram":
        raise AssertionError(f"hang drill forensics: {out}")
    return out


def drill_hang(initialize, GPT2Model, c, fa, tmp, telemetry_dir):
    """A hang on the ``train_step`` hook: the watchdog's WatchdogTimeout,
    the agent's restart from the RAM tier with steps_lost <= ram_interval,
    and the losses after the recovery equal to an unfaulted run's (the
    same steps on an engine without the blocks, which change no bit). The
    flight recorder is armed, and the agent's signal handlers installed:
    the chaos warning comes before the timeout's error, whose bundle is
    written; the restart's error lands in the ring and its bundle is
    rate-limited; one SIGUSR1 after the restart gives one bundle whose
    stacks hold the main thread; the incident report names the timeout at
    the hang's step as the first cause, with the restart's recovery."""
    import faulthandler
    import signal

    from deepspeed_tpu_torch import blackbox, env_report, telemetry
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch
    from deepspeed_tpu_torch.resilience import chaos
    from deepspeed_tpu_torch.resilience import rewind as rw
    from deepspeed_tpu_torch.telemetry import cli as metrics_cli

    rw.clear_ram_snapshots()            # the run starts with nothing to resume from
    feed = [synthetic_lm_batch(TRAIN_BATCH, TRAIN_SEQ, c.vocab_size, seed=SEED + 100 + i,
                               device="cuda") for i in range(DRILL_STEPS)]
    plain, *_ = initialize(model=GPT2Model(c), config=dict(TRAIN_CONFIG))
    want = {step: float(plain.train_batch(feed[step])) for step in range(DRILL_STEPS)}
    del plain
    torch.cuda.empty_cache()

    def batches(agent):
        while True:
            yield feed[agent.engine.global_steps % DRILL_STEPS]

    config = {**TRAIN_CONFIG, "rewind": dict(DRILL_REWIND), "watchdog": DRILL_WATCHDOG,
              "telemetry": {"enabled": True, "output_dir": telemetry_dir, "trace": False},
              "blackbox": {}}
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT, signal.SIGUSR1)}
    snap = {}
    _reset_counts(fa)
    chaos.install_chaos(chaos.ChaosInjector(hang_at={"train_step": [DRILL_HANG_AT]},
                                            hang_s=60.0))
    t0 = time.perf_counter()
    try:
        agent, out, seen, recorders = _drill_agent(
            initialize, GPT2Model, c, config, os.path.join(tmp, "hang"), batches, DRILL_STEPS,
            on_step=lambda a: _sigusr1_snap(a, snap), max_restarts=1,
            install_signal_handlers=True)
    finally:
        chaos.uninstall_chaos()
        blackbox.deconfigure()
        faulthandler.unregister(signal.SIGUSR1)
        for s, h in handlers.items():
            signal.signal(s, h)
    wall_s = time.perf_counter() - t0
    launches = _kernel_counts(fa)
    expect = dict.fromkeys(launches, c.n_layer * len(seen))
    rec = out["restart_log"][0] if out["restart_log"] else {}
    got = _by_step(seen)
    restart_log = os.path.join(telemetry_dir, "restart_log.jsonl")
    forensics = _hang_forensics(recorders, snap, telemetry_dir, rec)
    telemetry.flush()
    t_tools = time.perf_counter()
    footer = [line for line in _port_tool(metrics_cli.main, telemetry_dir)["stdout"]
              if line.startswith("incident:")]
    report_lines = _port_tool(env_report.main)["stdout"]
    card = [line for line in report_lines if "nvidia-smi name, power limit" in line]
    forensics.update(ds_metrics_incident_line=footer, ds_report_card=card,
                     tools_s=time.perf_counter() - t_tools)
    if not footer or "BUNDLES" not in footer[0] or not card \
            or nvidia_smi_line() not in card[0]:
        raise AssertionError(f"hang drill tools: ds_metrics {footer}, ds_report {card}")
    emit(f"resilience {TRAIN_MODEL}", part="hang drill", layers=c.n_layer,
         status=out["status"], final_step=out["final_step"], restarts=out["restarts"],
         restart_record=rec, watchdog=DRILL_WATCHDOG, hang_at_call=DRILL_HANG_AT,
         ram_interval=RESILIENCE_REWIND["ram_interval"], wall_s=wall_s,
         restart_log_jsonl=[json.loads(line) for line in open(restart_log)]
         if os.path.isfile(restart_log) else None,
         losses=got, losses_unfaulted=want, steps_trained=len(seen), blackbox=forensics,
         nvidia_smi=nvidia_smi_line(), launches=launches, launches_expected=expect)
    if out["status"] != "complete" or out["restarts"] != 1 \
            or "WatchdogTimeout" not in rec.get("error", "") or rec.get("tier") != "ram" \
            or not 0 <= rec.get("steps_lost", -1) <= RESILIENCE_REWIND["ram_interval"]:
        raise AssertionError(f"hang drill: {out['status']}, record {rec}")
    _held_bitwise(got, want, "hang drill against the unfaulted run")
    if launches != expect:
        raise AssertionError(f"hang drill: launch counts {launches}, expected {expect}")
    return launches


def _spike_forensics(rec, telemetry_dir) -> dict:
    """The spike drill's recorder: the rewind's ``rewind_recovery`` and
    ``sentinel_rewind`` events, one bundle, triggered by the latter, and
    the incident report naming it as the first cause."""
    ring = [(e["kind"], e["severity"], e["step"]) for e in rec.ring_snapshot()]
    report, text, report_s = _incident_report(telemetry_dir)
    cause = report["first_cause"] or {}
    out = {"ring": ring, "bundles": _triggers(telemetry_dir),
           "first_cause": cause, "incident_report_s": report_s,
           "incident_report": [line for line in text if not line.startswith("  ")]}
    kinds = [k for k, _, _ in ring]
    if out["bundles"] != ["sentinel_rewind"] or kinds.count("sentinel_rewind") != 1 \
            or "rewind_recovery" not in kinds or cause.get("kind") != "sentinel_rewind":
        raise AssertionError(f"spike drill forensics: {out}")
    return out


def drill_spike(initialize, GPT2Model, c, fa, tmp, telemetry_dir):
    """A loss spike: one batch repeated until its loss falls, then fresh
    batches; the sentinel rewinds in place from the RAM tier, no disk
    touched, once."""
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    memorized = synthetic_lm_batch(TRAIN_BATCH, TRAIN_SEQ, c.vocab_size, seed=SEED + 200,
                                   device="cuda")
    fresh = [synthetic_lm_batch(TRAIN_BATCH, TRAIN_SEQ, c.vocab_size, seed=SEED + 201 + i,
                                device="cuda") for i in range(SPIKE_FRESH)]
    save_dir = os.path.join(tmp, "spike")
    state = {"first": None, "repeats": 0, "fell": False, "rewound_at": None, "disk": None}

    def batches(agent):
        while not state["fell"]:
            if state["repeats"] >= SPIKE_MAX_REPEATS:
                raise AssertionError(f"spike drill: the repeated batch's loss did not fall "
                                     f"below {SPIKE_FALL} of its first in "
                                     f"{SPIKE_MAX_REPEATS} steps")
            state["repeats"] += 1
            yield memorized
        yield from fresh

    def on_step(step, loss):
        loss = float(loss)
        state["first"] = state["first"] or loss
        if not state["fell"] and loss < SPIKE_FALL * state["first"]:
            state["fell"] = True

    config = {**TRAIN_CONFIG, "optimizer": {"type": "AdamW", "params": {
        "lr": SPIKE_LR, "weight_decay": 0.01}},
              "rewind": {**DRILL_REWIND, "ram_interval": 1},
              "resilience": {"sentinel": dict(SPIKE_SENTINEL)},
              "telemetry": {"enabled": True, "output_dir": telemetry_dir, "trace": False},
              "blackbox": {"signal_snap": False}}
    from deepspeed_tpu_torch.elasticity import DSElasticAgent

    _reset_counts(fa)
    seen = []
    agent = DSElasticAgent(lambda: initialize(model=GPT2Model(c), config=dict(config))[0],
                           save_dir, checkpoint_interval=0, install_signal_handlers=False)

    def callback(step, loss):
        seen.append((step, float(loss)))
        on_step(step, loss)
        eng = agent.engine
        if eng._sentinel_rewinds and state["rewound_at"] is None:
            state["rewound_at"] = step
            state["disk"] = os.listdir(save_dir) if os.path.isdir(save_dir) else []
            state["recovery"] = dict(eng._rewind.last_recovery)
            state["ckpt_dir"] = eng._ckpt_save_dir

    from deepspeed_tpu_torch import blackbox

    try:
        out = agent.run(lambda: batches(agent), num_steps=10 ** 6, step_callback=callback)
        forensics = _spike_forensics(agent.engine._blackbox, telemetry_dir)
    finally:
        blackbox.deconfigure()
    counts = {",".join(f"{k}={v}" for k, v in sorted((r.get("labels") or {}).items())):
              r["value"] for r in telemetry.get_registry().snapshot()
              if r["name"] == "resilience/sentinel_rewinds"}
    launches = _kernel_counts(fa)
    expect = dict.fromkeys(launches, c.n_layer * len(seen))
    emit(f"resilience {TRAIN_MODEL}", part="loss spike drill", layers=c.n_layer,
         sentinel=SPIKE_SENTINEL, lr=SPIKE_LR, repeats=state["repeats"],
         losses=[loss for _, loss in seen], steps=[s for s, _ in seen],
         rewound_at_step=state["rewound_at"], recovery=state.get("recovery"),
         disk_at_rewind=state["disk"], ckpt_dir_at_rewind=state.get("ckpt_dir"),
         sentinel_rewinds=counts, status=out["status"], final_step=out["final_step"],
         blackbox=forensics, nvidia_smi=nvidia_smi_line(),
         launches=launches, launches_expected=expect)
    if counts != {"tier=ram": 1} or state["disk"] or state.get("ckpt_dir") \
            or (state.get("recovery") or {}).get("tier") != "ram" or out["status"] != "complete":
        raise AssertionError(f"spike drill: rewinds {counts}, disk at the rewind "
                             f"{state['disk']}, status {out['status']}")
    if launches != expect:
        raise AssertionError(f"spike drill: launch counts {launches}, expected {expect}")
    return launches


def drill_preempt(initialize, GPT2Model, c, fa, tmp):
    """``preempt_at`` on the train_step hook: the agent stops at the next
    boundary and writes ``emergency_step<N>``; an engine from another seed
    loads it in preference to the stale ``latest``, bitwise equal to the
    state at the stop, steps_lost 0."""
    import signal

    from deepspeed_tpu_torch.elasticity import DSElasticAgent
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch
    from deepspeed_tpu_torch.resilience import chaos
    from deepspeed_tpu_torch.resilience import rewind as rw
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (flatten_state,
                                                                       wait_for_pending_saves)

    batch = synthetic_lm_batch(TRAIN_BATCH, TRAIN_SEQ, c.vocab_size, seed=SEED + 300,
                               device="cuda")
    save_dir = os.path.join(tmp, "preempt")
    config = {**TRAIN_CONFIG, "rewind": dict(DRILL_REWIND)}
    peak = {}
    emergency_save = rw.RewindManager.emergency_save

    def measured(mgr, where):
        with _PeakRss() as rss:
            tag = emergency_save(mgr, where)
        peak.update(rss_start_gb=rss.start / 1e9, rss_peak_above_start_gb=rss.above_start / 1e9)
        return tag

    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    _reset_counts(fa)
    seen = []
    rw.RewindManager.emergency_save = measured
    chaos.install_chaos(chaos.ChaosInjector(preempt_at={"train_step": [DRILL_PREEMPT_AT]}))
    try:
        agent = DSElasticAgent(lambda: initialize(model=GPT2Model(c), config=dict(config))[0],
                               save_dir, checkpoint_interval=DRILL_CHECKPOINT_INTERVAL,
                               max_restarts=0, install_signal_handlers=True)
        out = agent.run(lambda: iter(lambda: batch, None), num_steps=50,
                        step_callback=lambda step, loss: seen.append(float(loss)))
        wait_for_pending_saves()
    finally:
        chaos.uninstall_chaos()
        rw.RewindManager.emergency_save = emergency_save
        for s, h in handlers.items():
            signal.signal(s, h)
    launches = _kernel_counts(fa)
    expect = dict.fromkeys(launches, c.n_layer * len(seen))
    record = dict(agent.engine._rewind.last_emergency or {})
    stopped = out["final_step"]
    want = flatten_state(agent.engine)
    agent.engine = None
    gc.collect()
    torch.cuda.empty_cache()
    with open(os.path.join(save_dir, "latest")) as f:
        latest = f.read().strip()
    fresh, *_ = initialize(model=GPT2Model(c), config={**config, "seed": SEED + 1})
    t0 = time.perf_counter()
    path, _ = fresh.load_checkpoint(save_dir)
    load_s = time.perf_counter() - t0
    got = flatten_state(fresh)
    differ = sorted(k for k in want if k not in got or not _bitwise_equal(got[k], want[k]))
    recovery = dict(fresh._last_recovery or {})
    emit(f"resilience {TRAIN_MODEL}", part="preempt drill", layers=c.n_layer,
         status=out["status"], final_step=stopped, preempt_at_call=DRILL_PREEMPT_AT,
         latest=latest, tags=sorted(os.listdir(save_dir)), loaded=os.path.basename(str(path)),
         recovery=recovery, load_s=load_s, tensors_differing=len(differ),
         emergency_save_s=record.get("seconds"), emergency_write_s=record.get("write_s"),
         emergency_capture_s=record.get("capture_s"),
         emergency_payload_bytes=record.get("payload_bytes"),
         emergency_write_gb_per_s=(record.get("payload_bytes") or 0)
         / max(record.get("write_s") or 1e-9, 1e-9) / 1e9, **peak,
         losses=seen, launches=launches, launches_expected=expect)
    if out["status"] != "preempted" or stopped != DRILL_PREEMPT_AT \
            or latest != f"global_step{DRILL_CHECKPOINT_INTERVAL}" \
            or os.path.basename(str(path)) != f"emergency_step{stopped}" \
            or recovery.get("tier") != "emergency" or recovery.get("steps_lost") != 0 or differ:
        raise AssertionError(f"preempt drill: {out['status']} at {stopped}, latest {latest}, "
                             f"loaded {path}, recovery {recovery}, {len(differ)} tensors "
                             f"differ ({differ[:4]})")
    if launches != expect:
        raise AssertionError(f"preempt drill: launch counts {launches}, expected {expect}")
    del fresh, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def resilience_slices(initialize, GPT2Model, cfg, accel, fa, ref_losses, ref_step_ms):
    """The armed training cell, then the hang, spike and preempt drills at
    RESUME_LAYERS layers, in a temporary directory on the disk with the
    most room. → launches by path."""
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.resilience import rewind as rw

    root, _ = _scratch_dir()
    tmp = tempfile.mkdtemp(prefix="ds_resilience_", dir=root)
    c4 = dataclasses.replace(cfg, n_layer=RESUME_LAYERS, remat=False)
    try:
        launches = {"resilience": resilience_armed(initialize, GPT2Model, cfg, accel, fa,
                                                   ref_losses, ref_step_ms, tmp)}
        launches["resilience_hang"] = drill_hang(initialize, GPT2Model, c4, fa, tmp,
                                                 os.path.join(tmp, "telemetry_hang"))
        rw.clear_ram_snapshots()
        launches["resilience_spike"] = drill_spike(initialize, GPT2Model, c4, fa, tmp,
                                                   os.path.join(tmp, "telemetry_spike"))
        rw.clear_ram_snapshots()
        launches["resilience_preempt"] = drill_preempt(initialize, GPT2Model, c4, fa, tmp)
    finally:
        telemetry.deconfigure()
        rw.clear_ram_snapshots()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# ------------------------------------------------- llama and BERT training
def _held_to(losses, ref, label) -> dict:
    """``losses`` against the reference run's: the largest relative
    difference, held to TRAIN_LOSS_RTOL, and whether they are equal bit for
    bit."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    if rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"{label}: losses {losses} vs the stage-1 run's {ref} "
                             f"(rel {rel})")
    return {"loss_rel_to_stage1": rel, "losses_bitwise_equal_to_stage1": losses == ref}


def _remat_run(engine_fn, c, batch, accel, fa, label, **fields) -> tuple:
    """One run under remat (llama3.2-1b's, gpt2-moe-125m's): the engine
    ``engine_fn()`` builds (its init seconds and peak), warm-up and timed
    steps, K1 twice and each K2 entry once per layer and step, and its
    line. → (engine, losses, launches, line)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = engine_fn()
    torch.cuda.synchronize()
    init = {"init_s": time.perf_counter() - t0,
            "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    losses, step_ms, peak_gb = _timed_steps(engine, batch, accel, (fa.KERNEL, fa.BWD_KERNEL))
    launches = _check_remat_launches(fa, c.n_layer, TRAIN_STEPS, label)
    rows, seq = batch["input_ids"].shape
    line = dict(**_train_line(c, rows, seq, step_ms, accel), remat=c.remat,
                layers=c.n_layer, heads=c.n_head, kv_heads=getattr(c, "n_kv_head", c.n_head),
                **init,
                peak_mem_gb=peak_gb, losses=losses,
                launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
                grad_norm=engine.get_global_grad_norm(), lr=engine.get_lr()[0], **fields)
    return engine, losses, launches, line


def llama_train_slices(initialize, init_inference, LlamaModel, cfg, accel, fa, da):
    """llama3.2-1b, the full preset (16 layers, d 2048, 32 query heads over
    8 KV heads, V 128256, tied, llama3 rope scaling, remat "full"), B=4 x
    T=2048, through initialize → train_batch with the training recipe:
    ZeRO stage 1, stage 3, and stage 3 with the optimizer state and the
    params in pinned host memory from a ``zero.Init`` build (the fp32 master
    on the host too); the stage-3 and offloaded losses held to stage 1's.
    Then the 2-layer kernel-vs-plain checks, and a stage-1 tag of the
    preset at LLAMA_TAG_LAYERS layers saved, served through
    ``init_inference(config={"checkpoint": ...})`` and consolidated. →
    launches by path."""
    import gc

    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch
    from deepspeed_tpu_torch.runtime import zero
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import wait_for_pending_saves

    c = cfg
    config = {**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": LLAMA_BATCH}
    batch = synthetic_lm_batch(LLAMA_BATCH, LLAMA_SEQ, c.vocab_size, seed=SEED, device="cuda")
    root, free = _scratch_dir()
    tmp = tempfile.mkdtemp(prefix="ds_llama_", dir=root)
    launches = {}
    try:
        label = f"train {MODEL}"
        engine, ref, launches["train_llama"], line = _remat_run(
            lambda: initialize(model=LlamaModel(c), config=dict(config))[0], c, batch, accel,
            fa, label)
        emit(label, **line)
        emit(f"profile {label}", step=device_profile(lambda: engine.train_batch(batch), top=12))
        del engine
        gc.collect()
        torch.cuda.empty_cache()

        label = f"train {MODEL} zero3"
        zero3 = {**config, "zero_optimization": {"stage": 3}}
        engine, losses, launches["train_llama_zero3"], line = _remat_run(
            lambda: initialize(model=LlamaModel(c), config=zero3)[0], c, batch, accel, fa,
            label)
        gathers = engine._zero.gathers / (TRAIN_WARMUP + TRAIN_STEPS)
        emit(label, **line, zero_stage=3, units=len(engine._plan.units),
             stage3_gathers_per_step=gathers, **_held_to(losses, ref, label))
        del engine
        gc.collect()
        torch.cuda.empty_cache()

        label = f"offload {MODEL}"
        cpu = {"device": "cpu"}
        offload = {**config, "zero_optimization": {"stage": 3, "offload_optimizer": cpu,
                                                   "offload_param": cpu}}

        def build():
            model = LlamaModel(c)
            with zero.Init(config=offload):
                zero.materialize(model, torch.Generator(device="cuda").manual_seed(SEED))
            return initialize(model=model, config=offload)[0]

        os.environ["DS_TPU_OFFLOAD_MASTER"] = "host"
        try:
            engine, losses, launches["offload_llama"], line = _remat_run(
                build, c, batch, accel, fa, label)
        finally:
            os.environ.pop("DS_TPU_OFFLOAD_MASTER", None)
        off = engine._offload
        emit(label, **line, zero=offload["zero_optimization"],
             policy={"master_on_host": off.master_host, "streamed": off.streamed,
                     "stream_overlap": off.overlap},
             host_state_gb=_host_state_bytes(engine) / 1e9,
             h2d_gb_per_update=off.h2d_bytes / 1e9, d2h_gb_per_update=off.d2h_bytes / 1e9,
             stage3_gathers_per_step=engine._zero.gathers / (TRAIN_WARMUP + TRAIN_STEPS),
             **_held_to(losses, ref, label), host_memory_after=_host_memory())
        if not off.master_host:
            raise AssertionError(f"{label}: the fp32 master stayed on the card")
        del engine, off
        gc.collect()
        torch.cuda.empty_cache()

        small = dataclasses.replace(c, n_layer=2, remat=False)
        train_check_bf16(LlamaModel, small, batch, MODEL, _dense_plain)
        train_check_fp32(initialize, LlamaModel, c, MODEL, LLAMA_SEQ, {}, _dense_plain)

        # the tag: the same recipe at LLAMA_TAG_LAYERS of the 16 layers (full
        # width), served and consolidated; the script's time limit stays
        # while it grows, and the save, the load and the HF layout are the
        # same per layer at 4 layers as at 16
        tc = dataclasses.replace(c, n_layer=LLAMA_TAG_LAYERS)
        engine = initialize(model=LlamaModel(tc), config=dict(config))[0]
        tag_losses = [float(engine.train_batch(batch)) for _ in range(TRAIN_WARMUP)]
        save_dir = os.path.join(tmp, "tag")
        t0 = time.perf_counter()
        engine.save_checkpoint(save_dir)
        blocking = time.perf_counter() - t0
        wait_for_pending_saves()
        emit(f"save {MODEL}", layers=tc.n_layer, losses=tag_losses, blocking_s=blocking,
             commit_s=time.perf_counter() - t0, tag_bytes=_tree_bytes(save_dir), dir=root,
             free_bytes=free[root])
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        launches["serve_llama_tag"] = serve_tag_slice(init_inference, LlamaModel, tc, accel,
                                                      fa, da, save_dir,
                                                      f"serve {MODEL} from its tag")
        consolidate_llama_tag(save_dir, tc)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def _bert_batch(rows, seq, vocab, seed, device, maxp=None):
    from deepspeed_tpu_torch.models.bert import synthetic_mlm_batch

    return synthetic_mlm_batch(rows, seq, vocab, seed=seed, max_predictions=maxp, device=device)


def train_check_bert_mask(BertModel, cfg, batch, fa):
    """One bf16 step of 2 layers with an ``attention_mask`` (each row's
    last eighth padded): attention takes the plain masked path, as in JAX,
    so no K1 launches, and the loss and gradients equal the plain path's
    bit for bit."""
    keep = torch.arange(batch["input_ids"].shape[1], device="cuda") \
        < batch["input_ids"].shape[1] * 7 // 8
    masked = {**batch, "attention_mask": keep[None].expand_as(batch["input_ids"])}
    model = BertModel(cfg).init_params(torch.Generator(device="cuda").manual_seed(SEED))
    model.to(dtype=torch.bfloat16)
    fa.KERNEL.reset_launches()
    fa.BWD_KERNEL.reset_launches()
    loss_k, grads_k = _grads(model, masked)
    launches = _dense_launches(fa)
    _dense_plain(model)
    loss_p, grads_p = _grads(model, masked)
    same = torch.equal(loss_k, loss_p) and all(torch.equal(grads_k[n], grads_p[n])
                                                for n in grads_k)
    emit(f"train check {BERT_MODEL} attention_mask", layers=cfg.n_layer, launches=launches,
         loss=loss_k.item(), bitwise_equal_to_plain=same)
    if any(launches.values()) or not same or not torch.isfinite(loss_k):
        raise AssertionError(f"masked BERT step: launches {launches}, equal to the plain "
                             f"path {same}, loss {loss_k.item()}")
    del model, grads_k, grads_p
    torch.cuda.empty_cache()


def bert_train_slices(initialize, BertModel, cfg, accel, fa):
    """bert-large masked-LM pretraining, full preset (24 layers, d 1024, 16
    heads), through initialize → train_batch with the reference's BERT
    recipe (LAMB, fp16 with dynamic loss scaling, clipping 1.0), no remat,
    at B=64 x T=128 (20 predictions a row) and B=16 x T=512 (80): each step
    launches K1 and each K2 entry once per layer, non-causal. Then the
    2-layer kernel-vs-plain checks and a masked step. → launches by path."""
    import gc

    launches = {}
    for batch_size, seq, maxp in BERT_SHAPES:
        c = dataclasses.replace(cfg, max_predictions_per_seq=maxp, dtype=torch.float16,
                                remat=False)
        config = {**BERT_CONFIG, "train_micro_batch_size_per_gpu": batch_size}
        engine, *_ = initialize(model=BertModel(c), config=config)
        batch = _bert_batch(batch_size, seq, c.vocab_size, SEED, "cuda", maxp)
        label = f"train {BERT_MODEL} seq{seq}"
        losses, step_ms, peak_gb = _timed_steps(engine, batch, accel,
                                                (fa.KERNEL, fa.BWD_KERNEL))
        launches[f"train_bert_s{seq}"] = got = _dense_launches(fa)
        expect = dict.fromkeys(got, c.n_layer * TRAIN_STEPS)
        if got != expect:
            raise AssertionError(f"{label}: launch counts {got} over {TRAIN_STEPS} steps, "
                                 f"expected {expect}")
        labels = int((batch["labels"] != -100).sum().item())
        emit(label, **_train_line(c, batch_size, seq, step_ms, accel, torch.float16),
             max_predictions_per_seq=maxp, labels_per_step=labels, causal=False,
             flops_per_token_gathered=c.flops_per_token(seq),
             flops_per_token_full_head=dataclasses.replace(
                 c, max_predictions_per_seq=None).flops_per_token(seq),
             peak_mem_gb=peak_gb, losses=losses, skipped_steps=engine.skipped_steps,
             loss_scale=engine.get_loss_scale(),
             launches_per_step={k: v / TRAIN_STEPS for k, v in got.items()},
             grad_norm=engine.get_global_grad_norm(), lr=engine.get_lr()[0])
        emit(f"profile {label}", step=device_profile(lambda: engine.train_batch(batch), top=12))
        del engine
        gc.collect()
        torch.cuda.empty_cache()

    rows, seq, maxp = BERT_SHAPES[0]
    small = dataclasses.replace(cfg, n_layer=2, max_predictions_per_seq=maxp)
    batch = _bert_batch(rows, seq, cfg.vocab_size, SEED, "cuda", maxp)
    train_check_bf16(BertModel, small, batch, BERT_MODEL, _dense_plain)
    train_check_fp32(initialize, BertModel, small, BERT_MODEL, seq, {}, _dense_plain,
                     make_batch=lambda *a, **kw: _bert_batch(*a, **kw, maxp=maxp))
    train_check_bert_mask(BertModel, small, batch, fa)
    return launches


def _moe_routing(model, n_experts: int) -> dict:
    """The recorded routing of each MoE layer's last call: ``l_aux``, the
    share of routed tokens dropped (weight 0), and the largest expert's
    routed load over the mean."""
    l_aux, dropped, load = [], [], []
    for layer in model.moe:
        r = layer.moe_layer.routing
        counts = (r["experts"].long()[..., None] == torch.arange(
            n_experts, device=r["experts"].device)).sum(dim=(0, 1)).float()
        l_aux.append(r["l_aux"].item())
        dropped.append((r["weights"] == 0).float().mean().item())
        load.append((counts.max() / counts.mean()).item())
    return {"l_aux_mean": sum(l_aux) / len(l_aux), "l_aux_by_layer": l_aux,
            "dropped_share": sum(dropped) / len(dropped), "dropped_share_by_layer": dropped,
            "max_load_over_mean": max(load), "max_load_over_mean_by_layer": load,
            "capacity": model.moe[0].moe_layer.routing["capacity"]}


def moe_train_slices(initialize, init_inference, MoECls, cfg, accel, fa, da):
    """gpt2-moe-125m (the registry's MoEGPT2 on the gpt2-125m preset: 12
    layers, d 768, 12 heads, V 50257, tied; 8 experts, top-1, capacity
    factor 1.25, aux coefficient 0.01; remat "full" per pair), B=12 x
    T=1024, through initialize → train_batch with the training recipe at
    ZeRO stage 1 (its routing, a profile, its tag saved) and at stage 3
    over a NCCL group of one (held to stage 1's losses); the 2-layer
    kernel-vs-plain checks; the switches of one card
    (``moe_switch_slices``); the tag served through
    ``init_inference(config={"checkpoint": ...})``. → launches by path."""
    import gc

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import wait_for_pending_saves

    c = cfg
    batch = synthetic_lm_batch(MOE_BATCH, MOE_SEQ, c.vocab_size, seed=SEED, device="cuda")
    root, free = _scratch_dir()
    tmp = tempfile.mkdtemp(prefix="ds_moe_", dir=root)
    launches = {}
    try:
        label = f"train {MOE_MODEL}"
        engine, ref, launches["train_moe"], line = _remat_run(
            lambda: initialize(model=MoECls(c), config=dict(MOE_CONFIG))[0], c, batch, accel,
            fa, label)
        model = engine.module
        for layer in model.moe:
            layer.moe_layer.record = True
        engine.train_batch(batch)                  # one more step, its routing kept
        routing = _moe_routing(model, model.num_experts)
        for layer in model.moe:
            layer.moe_layer.record = False
        n_params = sum(math.prod(p.shape) for p in engine._plan.params)
        emit(label, **line, experts=model.num_experts, top_k=model.moe[0].gate.k,
             capacity_factor=model.moe[0].gate.capacity_factor,
             params_with_experts=n_params,
             flops_accounting="dense-equivalent: one routed expert per token",
             **routing)
        emit(f"profile {label}",
             step=device_profile(lambda: engine.train_batch(batch), top=12, ranges=MOE_RANGES))
        save_dir = os.path.join(tmp, "tag")
        t0 = time.perf_counter()
        engine.save_checkpoint(save_dir)
        blocking = time.perf_counter() - t0
        wait_for_pending_saves()
        emit(f"save {MOE_MODEL}", blocking_s=blocking, commit_s=time.perf_counter() - t0,
             tag_bytes=_tree_bytes(save_dir), dir=root, free_bytes=free[root])
        del engine, model
        gc.collect()
        torch.cuda.empty_cache()

        label = f"train {MOE_MODEL} zero3"
        comm.init_distributed(init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                              world_size=1, timeout=600)
        try:
            zero3 = {**MOE_CONFIG, "zero_optimization": {"stage": 3}}
            engine, losses, launches["train_moe_zero3"], line = _remat_run(
                lambda: initialize(model=MoECls(c), config=zero3)[0], c, batch, accel, fa,
                label)
            gathers = engine._zero.gathers / (TRAIN_WARMUP + TRAIN_STEPS)
            emit(label, **line, backend=comm.get_backend(), world=comm.get_world_size(),
                 zero_stage=3, units=len(engine._plan.units), stage3_gathers_per_step=gathers,
                 **_held_to(losses, ref, label))
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            comm.destroy_process_group()

        small = dataclasses.replace(c, n_layer=2, remat=False)
        train_check_bf16(MoECls, small, batch, MOE_MODEL, _dense_plain)
        train_check_fp32(initialize, MoECls, c, MOE_MODEL, MOE_SEQ, {}, _dense_plain)
        launches.update(moe_switch_slices(initialize, MoECls, c, batch, ref, accel, fa))

        launches["serve_moe_tag"] = serve_tag_slice(init_inference, MoECls, c, accel, fa, da,
                                                    save_dir, f"serve {MOE_MODEL} from its tag")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def moe_switch_slices(initialize, MoECls, c, batch, ref, accel, fa):
    """gpt2-moe-125m under the switches of one card, each with the training
    recipe at MOE_BATCH x MOE_SEQ: ``offload_optimizer`` cpu at stage 2,
    and a ``zero.Init`` build at stage 3 (the expert banks placed and
    updated as the dense units), their losses held to the stage-1 run's
    ``ref`` at TRAIN_LOSS_RTOL as the dense offload phases are; then
    ``sparse_attention`` (SPARSE_BLOCK) at the registry widths: each step
    launches K4a twice (remat per pair) and K4b and K4c once per layer and
    no dense kernel, and one pair (a dense block and a MoE half-block) is
    held to the plain path in bf16 and fp32. → launches by path."""
    import gc

    from deepspeed_tpu_torch.runtime import zero

    launches = {}
    label = f"train {MOE_MODEL} offloaded"
    offload = {**MOE_CONFIG, "zero_optimization": {"stage": 2,
                                                   "offload_optimizer": {"device": "cpu"}}}
    engine, losses, launches["train_moe_offload"], line = _remat_run(
        lambda: initialize(model=MoECls(c), config=offload)[0], c, batch, accel, fa, label)
    off = engine._offload
    emit(label, **line, zero=offload["zero_optimization"],
         policy={"master_on_host": off.master_host, "streamed": off.streamed},
         host_state_gb=_host_state_bytes(engine) / 1e9,
         h2d_gb_per_update=off.h2d_bytes / 1e9, d2h_gb_per_update=off.d2h_bytes / 1e9,
         **_held_to(losses, ref, label))
    del engine, off
    gc.collect()
    torch.cuda.empty_cache()

    label = f"train {MOE_MODEL} zero.Init"
    zero3 = {**MOE_CONFIG, "zero_optimization": {"stage": 3}}

    def build():
        model = MoECls(c)
        with zero.Init(config=zero3):
            zero.materialize(model, torch.Generator(device="cuda").manual_seed(SEED))
        return initialize(model=model, config=zero3)[0]

    engine, losses, launches["train_moe_zero_init"], line = _remat_run(
        build, c, batch, accel, fa, label)
    emit(label, **line, zero_stage=3, units=len(engine._plan.units),
         stage3_gathers_per_step=engine._zero.gathers / (TRAIN_WARMUP + TRAIN_STEPS),
         **_held_to(losses, ref, label))
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    label = f"train {MOE_MODEL} sparse-fixed16"
    model = MoECls(c)
    engine, *_ = initialize(model=model, config={**MOE_CONFIG,
                                                 "sparse_attention": dict(SPARSE_BLOCK)})
    if model.config.sparse_attention != SPARSE_BLOCK:
        raise AssertionError(f"initialize did not carry the block: {model.config.sparse_attention}")
    losses, step_ms, peak_gb = _timed_steps(engine, batch, accel,
                                            (fa.KERNEL, fa.BWD_KERNEL, fa.SPARSE_KERNEL))
    sparse = {**fa.SPARSE_KERNEL.entry_launches, "flash_attention_fwd": fa.KERNEL.launches,
              "flash_attention_bwd": fa.BWD_KERNEL.launches}
    per = c.n_layer * TRAIN_STEPS
    expect = {"sparse_attention_fwd": 2 * per if c.remat in (True, "full") else per,
              "sparse_attention_bwd_dq": per, "sparse_attention_bwd_dkv": per,
              "flash_attention_fwd": 0, "flash_attention_bwd": 0}
    if sparse != expect:
        raise AssertionError(f"{label}: launch counts {sparse} over {TRAIN_STEPS} steps, "
                             f"expected {expect}")
    emit(label, **_train_line(c, MOE_BATCH, MOE_SEQ, step_ms, accel), remat=c.remat,
         sparse_attention=SPARSE_BLOCK, experts=model.num_experts, peak_mem_gb=peak_gb,
         losses=losses, launches_per_step={k: v / TRAIN_STEPS for k, v in sparse.items()},
         grad_norm=engine.get_global_grad_norm())
    launches["train_moe_sparse"] = sparse
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    block = dict(SPARSE_BLOCK)
    sparse_plain = lambda m: _sparse_plain(fa, m, block, MOE_SEQ)
    train_check_bf16(MoECls, dataclasses.replace(c, n_layer=2, remat=False,
                                                 sparse_attention=block),
                     batch, f"{MOE_MODEL} sparse-fixed16", sparse_plain)
    train_check_fp32(initialize, MoECls, c, f"{MOE_MODEL} sparse-fixed16", MOE_SEQ,
                     {"sparse_attention": dict(block)}, sparse_plain)
    return launches


# --------------------------------------------------------- stable diffusion
@contextlib.contextmanager
def _sd_plain(fa, clip):
    """The stable-diffusion models with their plain attention, swapped in
    here only: the UNet's and the VAE's attention dispatch becomes
    ``mha_reference`` (the package has no switch for it), the CLIP tower
    ``clip`` runs its config's plain path."""
    from deepspeed_tpu_torch.models import diffusion

    real, config = diffusion.local_causal_attention, clip.config
    diffusion.local_causal_attention = \
        lambda q, k, v, use_flash=True, causal=True: fa.mha_reference(q, k, v, causal=causal)
    _dense_plain(clip)
    try:
        yield
    finally:
        diffusion.local_causal_attention, clip.config = real, config


@contextlib.contextmanager
def _k1_calls(fa):
    """Counts the forward wrapper's calls by (head dim, causal, Tq, Tk) while
    held, each passed on unchanged: one launch each on the card."""
    real = fa.flash_forward
    seen = {}

    def probe(q, k, v, causal=True):
        key = (q.shape[-1], bool(causal), q.shape[1], k.shape[1])
        seen[key] = seen.get(key, 0) + 1
        return real(q, k, v, causal)

    fa.flash_forward = probe
    try:
        yield seen
    finally:
        fa.flash_forward = real


def _median_ms(fn, n: int = SD_TIMED) -> tuple:
    """Host ms of fn() to the device's end, n times → (median, each)."""
    each = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        each.append((time.perf_counter() - t0) * 1e3)
    return sorted(each)[n // 2], each


def _rel_max(out, ref) -> float:
    """Largest |out - ref| over the largest |ref|."""
    return max_err(out, ref) / ref.float().abs().max().clamp_min(1e-30).item()


def sd_expected_launches() -> dict:
    """K1 launches of the served request by (head dim, causal, Tq, Tk):
    CLIP's 12 causal layers at T = 77; per UNet forward, self and cross
    (77 keys) in 5 transformers at each of 64 x 64 (D 40) and 32 x 32
    (D 80), 5 at 16 x 16 and the mid block's at 8 x 8 (D 160); the VAE's
    mid attention (D 512, T 4096) in the decode and in the round trip's
    encode and decode."""
    out = {(64, True, SD_TOKENS, SD_TOKENS): CLIP_L14["n_layer"],
           (512, False, 4096, 4096): 3}
    for d, side, n in ((40, 64, 5), (80, 32, 5), (160, 16, 5), (160, 8, 1)):
        t = side * side
        out[(d, False, t, t)] = n * SD_STEPS
        out[(d, False, t, SD_TOKENS)] = n * SD_STEPS
    return out


def sd_serve_slice(init_inference, accel, fa, kernels):
    """``serve sd1.5``: the request of SD_PROMPTS prompts through the three
    engines at full width in bf16, every kernel count set to 0 just before
    and read just after (K1 per call by shape, against
    ``sd_expected_launches``); the outputs' shapes, finiteness and
    agreement with the plain attention; then ms per CLIP forward, per UNet
    forward and per VAE decode (median of SD_TIMED), the peak memory and a
    profile of one UNet forward. → the K1 calls by shape."""
    from deepspeed_tpu_torch.models import diffusion
    from deepspeed_tpu_torch.models.clip import CLIPTextEncoder
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config

    bf = torch.bfloat16
    t_build = time.perf_counter()
    clip = init_inference(CLIPTextEncoder(GPT2Config(**CLIP_L14, dtype=bf),
                                          eos_token_id=CLIP_EOS), config={"dtype": "bf16"})
    unet = init_inference(diffusion.UNet2DConditionModel(diffusion.UNetConfig(dtype=bf)),
                          config={"dtype": "bf16"})
    vae = init_inference(diffusion.AutoencoderKL(diffusion.VAEConfig(dtype=bf)),
                         config={"dtype": "bf16"})
    build_s = time.perf_counter() - t_build
    params = {n: sum(p.numel() for p in e.module.parameters())
              for n, e in (("clip", clip), ("unet", unet), ("vae", vae))}

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = 2 * SD_PROMPTS              # the prompts, then their unconditional rows
    ids = torch.randint(0, CLIP_BOS, (rows, SD_TOKENS), generator=gen, device="cuda")
    ids[:, 0] = CLIP_BOS
    ids[:SD_PROMPTS, 20:] = CLIP_EOS   # 19-token prompts, padded with EOS
    ids[SD_PROMPTS:, 1:] = CLIP_EOS    # the empty prompt
    latent0 = torch.randn(SD_PROMPTS, 4, SD_LATENT, SD_LATENT, generator=gen, device="cuda")
    image = torch.rand(1, 3, 8 * SD_LATENT, 8 * SD_LATENT, generator=gen, device="cuda") * 2 - 1
    steps = [int(t) for t in torch.linspace(999, 0, SD_STEPS).round()]

    def decode(latent):
        with torch.inference_mode():
            return vae.module.decode(latent)

    def request():
        ctx = clip.forward(ids)
        latent, first = latent0, None
        for t in steps:
            eps = unet.forward(torch.cat([latent, latent]), torch.tensor(t, device="cuda"), ctx)
            first = eps if first is None else first
            cond, uncond = eps.float().chunk(2)
            latent = latent - SD_STEP_SIZE * (uncond + SD_GUIDANCE * (cond - uncond))
        return ctx, first, latent, decode(latent), vae.forward(image)

    torch.cuda.synchronize()
    accel.reset_peak_memory_stats()
    for kern in kernels:
        kern.reset_launches()
    with _k1_calls(fa) as calls:
        t0 = time.perf_counter()
        ctx, eps0, latent, images, round_trip = request()
        torch.cuda.synchronize()
        request_s = time.perf_counter() - t0
    launches = {n: v for kern in kernels for n, v in kern.entry_launches.items() if v}
    peak_gb = accel.max_memory_allocated() / 1e9
    want = sd_expected_launches()
    shapes = {"context": (ctx, (rows, SD_TOKENS, 768)),
              "noise_prediction": (eps0, (rows, 4, SD_LATENT, SD_LATENT)),
              "latent": (latent, (SD_PROMPTS, 4, SD_LATENT, SD_LATENT)),
              "images": (images, (SD_PROMPTS, 3, 8 * SD_LATENT, 8 * SD_LATENT)),
              "round_trip": (round_trip, tuple(image.shape))}
    bad = {n: list(t.shape) for n, (t, shape) in shapes.items()
           if tuple(t.shape) != shape or not torch.isfinite(t.float()).all()}

    # the same models with the plain attention, on the same inputs
    x0, t0_dev = torch.cat([latent0, latent0]), torch.tensor(steps[0], device="cuda")
    with _sd_plain(fa, clip.module):
        plain = {"context": clip.forward(ids), "noise_prediction": unet.forward(x0, t0_dev, ctx),
                 "images": decode(latent), "round_trip": vae.forward(image)}
    errs = {n: _rel_max(shapes[n][0], ref) for n, ref in plain.items()}

    clip_ms, clip_each = _median_ms(lambda: clip.forward(ids))
    unet_ms, unet_each = _median_ms(lambda: unet.forward(x0, t0_dev, ctx))
    decode_ms, decode_each = _median_ms(lambda: decode(latent))
    prof = device_profile(lambda: unet.forward(x0, t0_dev, ctx), top=8)
    emit("serve sd1.5", params=params, prompts=SD_PROMPTS, rows=rows, steps=SD_STEPS,
         latent=[SD_LATENT, SD_LATENT], tokens=SD_TOKENS, build_s=build_s,
         request_s=request_s, launches=launches,
         k1_calls=[[*key, n] for key, n in sorted(calls.items())],
         k1_expected=[[*key, n] for key, n in sorted(want.items())],
         rel_err_vs_plain=errs, rtol=SD_RTOL, bad_outputs=bad,
         clip_forward_ms=clip_ms, clip_forward_ms_each=clip_each,
         unet_forward_ms=unet_ms, unet_forward_ms_each=unet_each,
         vae_decode_ms=decode_ms, vae_decode_ms_each=decode_each,
         peak_gb=peak_gb, unet_profile=prof)
    if calls != want or launches != {"flash_attention_fwd": sum(want.values())}:
        raise AssertionError(f"serve sd1.5: K1 calls {calls} (expected {want}), "
                             f"launches {launches}")
    if bad or max(errs.values()) > SD_RTOL:
        raise AssertionError(f"serve sd1.5: bad outputs {bad}; kernel vs plain {errs}")
    return calls


def sd_check_fp32(init_inference, fa):
    """fp32 on the card: SD-1.5's first two UNet blocks (320 and 640
    channels, both with cross-attention: head dims 40 and 80, 77 context
    keys), a VAE of two blocks (128, 512: its mid attention at head dim 512)
    and two CLIP layers, each through init_inference, held to the same
    model with the plain attention within FP32_RTOL of the largest
    |value|."""
    from deepspeed_tpu_torch.models import diffusion
    from deepspeed_tpu_torch.models.clip import CLIPTextEncoder
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config

    f32 = torch.float32
    two = ("CrossAttnDownBlock2D",) * 2
    unet = init_inference(diffusion.UNet2DConditionModel(diffusion.UNetConfig(
        block_out_channels=(320, 640), down_block_types=two,
        up_block_types=("CrossAttnUpBlock2D",) * 2, dtype=f32)), config={"dtype": "fp32"})
    vae = init_inference(diffusion.AutoencoderKL(diffusion.VAEConfig(
        block_out_channels=(128, 512), dtype=f32)), config={"dtype": "fp32"})
    clip = init_inference(CLIPTextEncoder(GPT2Config(**{**CLIP_L14, "n_layer": 2}, dtype=f32)),
                          config={"dtype": "fp32"})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.randn(2, 4, SD_LATENT, SD_LATENT, generator=gen, device="cuda")
    ctx = torch.randn(2, SD_TOKENS, 768, generator=gen, device="cuda")
    img = torch.rand(1, 3, 128, 128, generator=gen, device="cuda") * 2 - 1
    ids = torch.randint(0, CLIP_EOS + 1, (2, SD_TOKENS), generator=gen, device="cuda")
    t = torch.tensor([10, 500], device="cuda")
    fa.KERNEL.reset_launches()
    outs = {"unet": unet.forward(x, t, ctx), "vae": vae.forward(img), "clip": clip.forward(ids)}
    launches = fa.KERNEL.launches
    with _sd_plain(fa, clip.module):
        refs = {"unet": unet.forward(x, t, ctx), "vae": vae.forward(img),
                "clip": clip.forward(ids)}
    errs = {n: _rel_max(outs[n], refs[n]) for n in outs}
    # UNet: 11 transformers (2 + 2 down, the mid's, 3 + 3 up), two K1 each;
    # VAE: the encoder's and the decoder's mid attention; CLIP: 2 layers
    want = 2 * 11 + 2 + 2
    emit("check sd1.5 fp32 2-block", rel_err_vs_plain=errs, rtol=FP32_RTOL,
         launches=launches, expected_launches=want)
    if launches != want or max(errs.values()) > FP32_RTOL or not all(
            torch.isfinite(o).all() for o in outs.values()):
        raise AssertionError(f"sd1.5 fp32 2-block: kernel vs plain {errs}, launches "
                             f"{launches} (expected {want})")


def sd_slices(init_inference, accel, fa, kernels):
    """The stable-diffusion phases: the served request at full width, then
    the fp32 2-block checks. → the request's K1 calls by shape."""
    t0 = time.perf_counter()
    calls = sd_serve_slice(init_inference, accel, fa, kernels)
    sd_check_fp32(init_inference, fa)
    torch.cuda.empty_cache()
    emit("sd1.5 seconds", seconds=time.perf_counter() - t0)
    return calls


# ------------------------------------------------- GPT-2 variant families
def hf_lm_state(family: str, cfg: dict, layers: int, gen, dtype=torch.bfloat16,
                q_std: float = 0.02):
    """An HF-shaped (config dict, state dict) of ``family`` ("gpt_neox",
    "opt", "gpt_neo", "bloom", "gptj", "llama", "bert", "distilbert") at the
    widths of ``cfg`` (a GPT2Config's, LlamaConfig's or BertConfig's fields)
    with ``layers`` layers, built on the card: HF's key names and tensor
    shapes (``nn.Linear`` (out, in), BLOOM's and NeoX's head-interleaved
    ``query_key_value``, OPT's position table with its 2 extra rows, GPT-J's
    bias-free attention, llama's grouped ``k_proj``/``v_proj`` and no
    ``lm_head`` when tied, BERT's and DistilBERT's separate q/k/v and MLM
    heads without the tied decoder weight), normal(0.02) weights (GPT-Neo's
    ``q_proj`` normal(``q_std``)), unit gains, zero biases."""
    d, h, vocab, npos = cfg["n_embd"], cfg["n_head"], cfg["vocab_size"], cfg["n_positions"]
    sd = {}

    def put(name, *shape, std=0.02):
        sd[name] = (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    def ln(name, bias=True):
        sd[name + ".weight"] = torch.ones(d, dtype=dtype, device="cuda")
        if bias:
            sd[name + ".bias"] = torch.zeros(d, dtype=dtype, device="cuda")

    def linear(name, n_out, n_in, bias=True, std=0.02):
        put(name + ".weight", n_out, n_in, std=std)
        if bias:
            sd[name + ".bias"] = torch.zeros(n_out, dtype=dtype, device="cuda")

    if family == "llama":
        kv, inter = cfg["n_kv_head"] * (d // h), cfg["intermediate_size"]
        put("model.embed_tokens.weight", vocab, d)
        for i in range(layers):
            p = f"model.layers.{i}."
            ln(p + "input_layernorm", bias=False)
            ln(p + "post_attention_layernorm", bias=False)
            for n, rows in (("q", d), ("k", kv), ("v", kv), ("o", d)):
                linear(p + f"self_attn.{n}_proj", rows, d, bias=False)
            linear(p + "mlp.gate_proj", inter, d, bias=False)
            linear(p + "mlp.up_proj", inter, d, bias=False)
            linear(p + "mlp.down_proj", d, inter, bias=False)
        ln("model.norm", bias=False)
        if not cfg["tie_embeddings"]:
            put("lm_head.weight", vocab, d)
        config = {"model_type": "llama", "num_attention_heads": h,
                  "num_key_value_heads": cfg["n_kv_head"], "rms_norm_eps": cfg["rms_norm_eps"],
                  "rope_theta": cfg["rope_theta"], "rope_scaling": cfg["rope_scaling"],
                  "max_position_embeddings": npos, "intermediate_size": inter,
                  "tie_word_embeddings": cfg["tie_embeddings"]}
    elif family in ("bert", "distilbert"):
        inter = cfg["intermediate_size"]
        e = f"{family}.embeddings."
        put(e + "word_embeddings.weight", vocab, d)
        put(e + "position_embeddings.weight", npos, d)
        ln(e + "LayerNorm")
        for i in range(layers):
            if family == "bert":
                p = f"bert.encoder.layer.{i}."
                for n in ("query", "key", "value"):
                    linear(p + f"attention.self.{n}", d, d)
                linear(p + "attention.output.dense", d, d)
                ln(p + "attention.output.LayerNorm")
                linear(p + "intermediate.dense", inter, d)
                linear(p + "output.dense", d, inter)
                ln(p + "output.LayerNorm")
            else:
                p = f"distilbert.transformer.layer.{i}."
                for n in ("q", "k", "v", "out"):
                    linear(p + f"attention.{n}_lin", d, d)
                ln(p + "sa_layer_norm")
                linear(p + "ffn.lin1", inter, d)
                linear(p + "ffn.lin2", d, inter)
                ln(p + "output_layer_norm")
        if family == "bert":
            put(e + "token_type_embeddings.weight", cfg["type_vocab_size"], d)
            linear("cls.predictions.transform.dense", d, d)
            ln("cls.predictions.transform.LayerNorm")
            sd["cls.predictions.bias"] = torch.zeros(vocab, dtype=dtype, device="cuda")
            config = {"model_type": "bert", "num_attention_heads": h,
                      "intermediate_size": inter, "hidden_act": cfg["activation"],
                      "layer_norm_eps": cfg["layer_norm_eps"], "max_position_embeddings": npos,
                      "type_vocab_size": cfg["type_vocab_size"],
                      "position_embedding_type": "absolute"}
        else:
            linear("vocab_transform", d, d)
            ln("vocab_layer_norm")
            sd["vocab_projector.bias"] = torch.zeros(vocab, dtype=dtype, device="cuda")
            config = {"model_type": "distilbert", "n_heads": h, "hidden_dim": inter,
                      "activation": cfg["activation"], "max_position_embeddings": npos}
    elif family == "gpt_neox":
        put("gpt_neox.embed_in.weight", vocab, d)
        for i in range(layers):
            p = f"gpt_neox.layers.{i}."
            ln(p + "input_layernorm")
            ln(p + "post_attention_layernorm")
            linear(p + "attention.query_key_value", 3 * d, d)
            linear(p + "attention.dense", d, d)
            linear(p + "mlp.dense_h_to_4h", 4 * d, d)
            linear(p + "mlp.dense_4h_to_h", d, 4 * d)
        ln("gpt_neox.final_layer_norm")
        put("embed_out.weight", vocab, d)
        config = {"model_type": "gpt_neox", "num_attention_heads": h,
                  "rotary_pct": cfg["rotary_pct"], "rotary_emb_base": cfg["rotary_theta"],
                  "use_parallel_residual": True, "hidden_act": cfg["activation"],
                  "max_position_embeddings": npos}
    elif family == "opt":
        put("model.decoder.embed_tokens.weight", vocab, d)
        put("model.decoder.embed_positions.weight", npos + 2, d)
        for i in range(layers):
            p = f"model.decoder.layers.{i}."
            for n in "qkv":
                linear(p + f"self_attn.{n}_proj", d, d)
            linear(p + "self_attn.out_proj", d, d)
            ln(p + "self_attn_layer_norm")
            ln(p + "final_layer_norm")
            linear(p + "fc1", 4 * d, d)
            linear(p + "fc2", d, 4 * d)
        ln("model.decoder.final_layer_norm")
        config = {"model_type": "opt", "num_attention_heads": h, "hidden_size": d,
                  "word_embed_proj_dim": d, "activation_function": "relu",
                  "do_layer_norm_before": True}
    elif family == "gpt_neo":
        put("transformer.wte.weight", vocab, d)
        put("transformer.wpe.weight", npos, d)
        for i in range(layers):
            p = f"transformer.h.{i}."
            ln(p + "ln_1")
            ln(p + "ln_2")
            for n in "qkv":
                linear(p + f"attn.attention.{n}_proj", d, d, bias=False,
                       std=q_std if n == "q" else 0.02)
            linear(p + "attn.attention.out_proj", d, d)
            linear(p + "mlp.c_fc", 4 * d, d)
            linear(p + "mlp.c_proj", d, 4 * d)
        ln("transformer.ln_f")
        config = {"model_type": "gpt_neo", "num_heads": h, "window_size": cfg["window_size"],
                  "attention_layers": list(cfg["attention_layers"][:layers]),
                  "max_position_embeddings": npos, "activation_function": "gelu_new"}
    elif family == "bloom":
        put("transformer.word_embeddings.weight", vocab, d)
        ln("transformer.word_embeddings_layernorm")
        for i in range(layers):
            p = f"transformer.h.{i}."
            ln(p + "input_layernorm")
            ln(p + "post_attention_layernorm")
            linear(p + "self_attention.query_key_value", 3 * d, d)
            linear(p + "self_attention.dense", d, d)
            linear(p + "mlp.dense_h_to_4h", 4 * d, d)
            linear(p + "mlp.dense_4h_to_h", d, 4 * d)
        ln("transformer.ln_f")
        config = {"model_type": "bloom", "n_head": h}
    else:
        put("transformer.wte.weight", vocab, d)
        for i in range(layers):
            p = f"transformer.h.{i}."
            ln(p + "ln_1")
            for n in "qkv":
                linear(p + f"attn.{n}_proj", d, d, bias=False)
            linear(p + "attn.out_proj", d, d, bias=False)
            linear(p + "mlp.fc_in", 4 * d, d)
            linear(p + "mlp.fc_out", d, 4 * d)
        ln("transformer.ln_f")
        linear("lm_head", vocab, d)
        config = {"model_type": "gptj", "n_head": h,
                  "rotary_dim": round(cfg["rotary_pct"] * d // h), "n_positions": npos}
    return config, sd


class _HFObject:
    """What a loader takes: ``.config`` (a dict here: the card's machine has
    no ``transformers``) and ``state_dict()``."""

    def __init__(self, config, sd):
        self.config, self._sd = config, sd

    def state_dict(self):
        return self._sd


def _variant_cfg(name: str, **over):
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config

    return GPT2Config(**{**VARIANT_MODELS[name], **over})


def _kernel_layers(c) -> int:
    """The layers that reach K1 and K3: none under ALiBi, the global ones
    under GPT-Neo's pattern."""
    if c.alibi:
        return 0
    if c.attention_layers is None:
        return c.n_layer
    return sum(1 for a in c.attention_layers if a == "global")


def serve_variant(init_inference, model, sd, name, accel, fa, da, prompt=PROMPT, **fields):
    """A GPT2Model of ``model``'s config served from the state dict ``sd``
    (emptied once loaded) through ``init_inference`` in bf16 with the decode
    kernel: the counted graphed ``generate`` beside the ungraphed loop and
    the plain path (``_served_cell``). → the second generate's launches."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model

    c = dataclasses.replace(model.config, use_flash_decode=True, dtype=torch.bfloat16)
    model = GPT2Model(c)
    t0 = time.perf_counter()
    engine = init_inference(model, {"dtype": "bfloat16", "max_out_tokens": prompt + GEN},
                            params=sd)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ids = torch.randint(0, c.vocab_size, (BATCH, prompt), generator=gen, device="cuda")
    sd.clear()                     # the engine holds the weights now, in bf16
    launches, loop, _, _ = _served_cell(
        engine, ids, accel, fa, da, f"serve {name}", kernel_layers=_kernel_layers(c),
        layers=c.n_layer, params=sum(p.numel() for p in engine.module.parameters()),
        switches={k: getattr(c, k) for k in ("alibi", "rotary_pct", "rotary_interleaved",
                                             "parallel_residual", "activation",
                                             "lm_head_bias", "embed_layernorm")},
        window=c.window_size if c.attention_layers else None, init_inference_s=load_s,
        nvidia_smi=nvidia_smi_line(), **fields)
    del engine, model, loop
    torch.cuda.empty_cache()
    return launches


def serve_from_hf(init_inference, name, family, accel, fa, da, prompt=PROMPT, q_std=0.02):
    """An HF-shaped state dict of ``name`` built on the card, loaded by
    ``load_hf_model`` (the config as a dict) in bf16, its switches held to
    the published config's, and served."""
    from deepspeed_tpu_torch.module_inject.hf import load_hf_model

    cfg = VARIANT_MODELS[name]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    config, sd = hf_lm_state(family, cfg, cfg["n_layer"], gen, q_std=q_std)
    model, params = load_hf_model(_HFObject(config, sd), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del sd
    want = _variant_cfg(name)
    for key in ("vocab_size", "n_embd", "n_layer", "n_head", "alibi", "embed_layernorm",
                "rotary_pct", "rotary_interleaved", "parallel_residual", "tie_embeddings",
                "lm_head_bias", "attention_layers", "activation"):
        if getattr(model.config, key) != getattr(want, key):
            raise AssertionError(f"load_hf_model {name}: {key} {getattr(model.config, key)} "
                                 f"!= {getattr(want, key)}")
    launches = serve_variant(init_inference, model, params, f"{name} from hf", accel, fa, da,
                             prompt, hf_family=family, hf_load_s=load_s, q_proj_std=q_std)
    del params
    torch.cuda.empty_cache()
    return launches


def check_gptneo_hf_init(fa):
    """GPT-Neo at HF's own init: ``q_proj`` drawn at 0.02 with no 1/sqrt(dh)
    in its attention gives scores of std ≈ 9 at d 2048, a near one-hot
    softmax, where any two roundings of the scores part over the layers. At
    full depth, B 4 x ``NEO_PROMPT``, for each of ``NEO_HF_INIT["seeds"]``:
    the bf16 kernel path against the bf16 plain path (reported), and each
    against the fp32 plain path, the kernel path's max and mean errors held
    within ``NEO_HF_INIT["ratio"]`` of the plain path's (a kernel fault
    would part from fp32 further than the plain path's rounding does); at 2
    layers the fp32 kernel path against the fp32 plain path (within
    ``FP32_RTOL`` of the largest logit). Why the served phase draws
    ``q_proj`` at 0.02 / sqrt(dh)."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model
    from deepspeed_tpu_torch.module_inject.hf import load_hf_model

    cfg = VARIANT_MODELS["gpt-neo-1.3b"]
    ratio = NEO_HF_INIT["ratio"]
    by_seed, faults = {}, []
    for seed in NEO_HF_INIT["seeds"]:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        config, sd = hf_lm_state("gpt_neo", cfg, cfg["n_layer"], gen)
        model, params = load_hf_model(_HFObject(config, sd), dtype=torch.bfloat16)
        del sd
        c = model.config
        ids = torch.randint(0, c.vocab_size, (4, NEO_PROMPT), generator=gen, device="cuda")

        def prefill(layers, dtype, flash):
            m = GPT2Model(dataclasses.replace(c, n_layer=layers, dtype=dtype,
                                              attention_layers=c.attention_layers[:layers],
                                              use_flash_attention=flash))
            m.load_state_dict({k: v.to(dtype) for k, v in params.items()
                               if not k.startswith("blocks.") or int(k.split(".")[1]) < layers},
                              assign=True)
            with torch.inference_mode():
                return m.prefill(ids, m.init_cache(4, NEO_PROMPT))[0].float()

        f32 = torch.float32
        ref = prefill(c.n_layer, f32, False)
        out = {path: prefill(c.n_layer, torch.bfloat16, flash)
               for path, flash in (("kernel", True), ("plain", False))}
        to_fp32 = {path: {"max": max_err(o, ref), "mean": (o - ref).abs().mean().item()}
                   for path, o in out.items()}
        small_ref = prefill(2, f32, False)
        small_err = max_err(prefill(2, f32, True), small_ref)
        by_seed[seed] = {
            "bf16_kernel_vs_plain": {"max": max_err(out["kernel"], out["plain"]),
                                     "mean": (out["kernel"] - out["plain"]).abs().mean().item(),
                                     "top1_agree": (out["kernel"].argmax(-1) == out["plain"]
                                                    .argmax(-1)).float().mean().item()},
            "bf16_err_to_fp32": to_fp32,
            "kernel_over_plain": {k: to_fp32["kernel"][k] / to_fp32["plain"][k]
                                  for k in ("max", "mean")},
            "ref_logits_max_abs": ref.abs().max().item(),
            "fp32_2layer_kernel_vs_plain": small_err}
        over = by_seed[seed]["kernel_over_plain"].values()
        if not small_err <= FP32_RTOL * small_ref.abs().max().item() \
                or not all(math.isfinite(v) and v <= ratio for v in over):
            faults.append(seed)
        del params, out, ref
        torch.cuda.empty_cache()
    emit("check gpt-neo-1.3b hf init", q_proj_std=0.02, ratio_limit=ratio, fp32_rtol=FP32_RTOL,
         by_seed=by_seed, nvidia_smi=nvidia_smi_line())
    if faults:
        raise AssertionError(f"GPT-Neo at HF init, seeds {faults}: "
                             f"{ {s: by_seed[s] for s in faults} }")


def check_gptj_loader(init_inference, accel, fa, da):
    """GPT-J's loader at its published widths on 2 layers: the HF-shaped
    dict loaded in bf16 (ln_1 in both ln slots, zero attention biases, the
    head bias), served through the kernels at head dim 256 with the graphed
    loop against the ungraphed one and the plain path."""
    from deepspeed_tpu_torch.module_inject.hf import load_hf_model

    cfg = VARIANT_MODELS["gpt-j-6b"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    config, sd = hf_lm_state("gptj", cfg, GPTJ_LOADER_LAYERS, gen)
    model, params = load_hf_model(_HFObject(config, sd), dtype=torch.bfloat16)
    c = model.config
    if not (c.rotary_interleaved and c.parallel_residual and c.lm_head_bias
            and c.head_dim == 256 and torch.equal(params["blocks.1.ln2_g"],
                                                  sd["transformer.h.1.ln_1.weight"])
            and not params["blocks.0.qkv_b"].any()):
        raise AssertionError(f"load_gptj at GPT-J's widths: {c}")
    del sd
    return serve_variant(init_inference, model, params,
                         f"check gpt-j-6b loader {GPTJ_LOADER_LAYERS}-layer", accel, fa, da)


def train_pythia(initialize, accel, fa):
    """pythia-1.4b at full width and depth, 4 x 2048, bf16, AdamW, ZeRO
    stage 1, through initialize → train_batch under remat "attn" (24 K1 and
    24 of each K2 entry a step: the recompute reads K1's outputs back), then
    "full" and "dots" (48 K1 a step), their losses within 1% of "attn"'s;
    then, at 2 layers under remat "attn", the kernel path against the plain
    path: one bf16 step's loss and gradients on the same batch, and three
    fp32 AdamW steps through the engine. → launches by run."""
    import gc

    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, synthetic_lm_batch

    config = {**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": PYTHIA_BATCH}
    launches, ref = {}, None
    batch = synthetic_lm_batch(PYTHIA_BATCH, PYTHIA_SEQ, VARIANT_MODELS[PYTHIA]["vocab_size"],
                               seed=SEED, device="cuda")
    for remat in PYTHIA_REMATS:
        c = _variant_cfg(PYTHIA, remat=remat)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine, *_ = initialize(model=GPT2Model(c), config=dict(config))
        init_s = time.perf_counter() - t0
        losses, step_ms, peak_gb = _timed_steps(engine, batch, accel, (fa.KERNEL, fa.BWD_KERNEL))
        got = _dense_launches(fa)
        k1 = (1 if remat in ("attn", "attn_mlp") else 2) * c.n_layer * TRAIN_STEPS
        expect = {"flash_attention_fwd": k1,
                  **dict.fromkeys(fa.BWD_KERNEL.entry_launches, c.n_layer * TRAIN_STEPS)}
        label = f"train {PYTHIA} {remat}"
        if got != expect:
            raise AssertionError(f"{label}: launch counts {got} over {TRAIN_STEPS} steps, "
                                 f"expected {expect}")
        held = {}
        if ref is None:
            ref = losses
        else:
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
            held = {"loss_rel_to_attn": rel}
            if rel > TRAIN_LOSS_RTOL:
                raise AssertionError(f"{label}: losses {losses} vs remat attn's {ref}")
        launches[f"train_pythia_{remat}"] = got
        params = sum(p.numel() for p in engine.module.parameters())
        line = _train_line(c, PYTHIA_BATCH, PYTHIA_SEQ, step_ms, accel)
        # MFU from the model's own parameter count (GPT2Config.num_params
        # counts a position table and no untied head, as the JAX one does)
        step_s = line["step_ms"] / 1e3
        flops = (6 * params + 12 * c.n_layer * c.n_embd * PYTHIA_SEQ) * PYTHIA_BATCH * PYTHIA_SEQ
        emit(label, **line, remat=remat, layers=c.n_layer, heads=c.n_head, head_dim=c.head_dim,
             model_params=params, mfu_model_params=flops / step_s / accel.peak_flops(
                 torch.bfloat16), init_s=init_s, peak_mem_gb=peak_gb, losses=losses,
             launches_per_step={k: v / TRAIN_STEPS for k, v in got.items()}, **held,
             grad_norm=engine.get_global_grad_norm(), nvidia_smi=nvidia_smi_line())
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    train_check_bf16(GPT2Model, _variant_cfg(PYTHIA, n_layer=2, remat="attn"), batch, PYTHIA,
                     _dense_plain)
    train_check_fp32(initialize, GPT2Model, _variant_cfg(PYTHIA), PYTHIA, PYTHIA_SEQ, {},
                     _dense_plain, remat="attn")
    return launches


def check_pythia_dropout(accel):
    """2 layers at pythia-1.4b's widths, fp32, dropout 0.1: one loss and its
    gradients under remat "attn" and under remat off from generators of the
    same seed; the recompute draws the same masks, so every gradient is
    within ``DROPOUT_CHECK["rtol"]`` of remat off's (relative L2)."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, synthetic_lm_batch

    k = DROPOUT_CHECK
    c = _variant_cfg(PYTHIA, n_layer=2, dropout=k["p"], dtype=torch.float32)
    model = GPT2Model(c).init_params(torch.Generator(device="cuda").manual_seed(SEED))
    batch = synthetic_lm_batch(k["batch"], k["seq"], c.vocab_size, seed=SEED, device="cuda")
    runs = {}
    for remat in ("attn", False):
        model.config = dataclasses.replace(c, remat=remat)
        model.zero_grad(set_to_none=True)
        loss = model.loss(batch, generator=torch.Generator(device="cuda").manual_seed(SEED))
        loss.backward()
        runs[remat] = (loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()})
    rel = {n: _rel_l2(g, runs[False][1][n]) for n, g in runs["attn"][1].items()}
    worst = max(rel, key=rel.get)
    with torch.no_grad():
        no_drop = model.loss(batch).item()
    emit(f"train check {PYTHIA} dropout", layers=2, **k, loss_attn=runs["attn"][0],
         loss_off=runs[False][0], loss_without_dropout=no_drop, grad_rel_l2_max=rel[worst],
         grad_rel_l2_worst=worst)
    if rel[worst] > k["rtol"] or runs["attn"][0] != runs[False][0] or no_drop == runs[False][0]:
        raise AssertionError(f"dropout under remat attn vs off: grad rel {rel[worst]} at "
                             f"{worst}, losses {runs['attn'][0]} / {runs[False][0]}")
    del model, runs
    torch.cuda.empty_cache()


def train_bert_pld(initialize, BertModel, cfg, accel, fa):
    """bert-large masked-LM at 64 x 128 with the ds_config
    ``progressive_layer_drop`` block (θ 0.5, γ 0.001): the θ each step's
    loss receives equals ``theta_at`` of the step; the losses are finite;
    the median step beside the same run with PLD off. → launches."""
    import gc

    from deepspeed_tpu_torch.runtime.progressive_layer_drop import theta_at

    class Recording(BertModel):
        def loss(self, batch, pld_theta=None, generator=None):
            self.seen.append(pld_theta)
            return super().loss(batch, pld_theta, generator)

    rows, seq, maxp = BERT_SHAPES[0]
    c = dataclasses.replace(cfg, max_predictions_per_seq=maxp, dtype=torch.float16, remat=False)
    batch = _bert_batch(rows, seq, c.vocab_size, SEED, "cuda", maxp)
    out, launches = {}, None
    for pld in (PLD, None):
        model = Recording(c)
        model.seen = []
        config = {**BERT_CONFIG, "train_micro_batch_size_per_gpu": rows,
                  **({"progressive_layer_drop": pld} if pld else {})}
        engine, *_ = initialize(model=model, config=config)
        losses, step_ms, _ = _timed_steps(engine, batch, accel, (fa.KERNEL, fa.BWD_KERNEL))
        out[pld is not None] = (losses, sorted(step_ms)[TRAIN_STEPS // 2], list(model.seen))
        if pld:
            launches = _dense_launches(fa)
        del engine, model
        gc.collect()
        torch.cuda.empty_cache()
    losses, step_ms, seen = out[True]
    want = [theta_at(s, PLD["theta"], PLD["gamma"]) for s in range(len(seen))]
    emit(f"train {BERT_MODEL} pld", batch=rows, seq=seq, pld=PLD, losses=losses,
         thetas=seen, step_ms=step_ms, step_ms_pld_off=out[False][1],
         losses_pld_off=out[False][0], launches_per_step={
             k: v / TRAIN_STEPS for k, v in launches.items()}, nvidia_smi=nvidia_smi_line())
    if seen != want or out[False][2] != [None] * len(seen) \
            or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"PLD: thetas {seen} vs theta_at {want}; losses {losses}")
    return launches


def variant_slices(initialize, init_inference, BertModel, bert_cfg, accel, fa, da):
    """The GPT-2 variant families: pythia-1.4b trained under three remat
    policies and its dropout check, then pythia-1.4b, OPT-1.3b, GPT-Neo-1.3B
    and BLOOM-560m served from HF-shaped dicts through ``load_hf_model``,
    GPT-J-6B (head dim 256) built by the port's own init and served, its
    loader checked on 2 layers, and bert-large under progressive layer drop.
    → launches by path."""
    launches = train_pythia(initialize, accel, fa)
    check_pythia_dropout(accel)
    # GPT-Neo's attention has no 1/sqrt(dh): its q_proj is drawn at 0.02 /
    # sqrt(dh), the scores' spread of the other families (check_gptneo_hf_init)
    neo_q_std = 0.02 / math.sqrt(VARIANT_MODELS["gpt-neo-1.3b"]["n_embd"]
                                 // VARIANT_MODELS["gpt-neo-1.3b"]["n_head"])
    for name, family, prompt, q_std in ((PYTHIA, "gpt_neox", PROMPT, 0.02),
                                        ("opt-1.3b", "opt", PROMPT, 0.02),
                                        ("gpt-neo-1.3b", "gpt_neo", NEO_PROMPT, neo_q_std),
                                        ("bloom-560m", "bloom", PROMPT, 0.02)):
        launches[f"serve_{name}"] = serve_from_hf(init_inference, name, family, accel, fa, da,
                                                  prompt, q_std)
    check_gptneo_hf_init(fa)
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model

    c = _variant_cfg("gpt-j-6b")
    t0 = time.perf_counter()
    model = GPT2Model(c).init_params(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sd = model.state_dict()
    del model
    launches["serve_gpt-j-6b"] = serve_variant(init_inference, GPT2Model(c), sd, "gpt-j-6b",
                                               accel, fa, da, init_params_s=init_s)
    torch.cuda.empty_cache()
    launches["check_gptj_loader"] = check_gptj_loader(init_inference, accel, fa, da)
    launches["train_bert_pld"] = train_bert_pld(initialize, BertModel, bert_cfg, accel, fa)
    return launches


# ------------------------------------------------------------ model import
def _config_held_to(config, want, keys, label):
    """``config``'s ``keys`` equal ``want``'s (the published widths), else
    raise."""
    for key in keys:
        if getattr(config, key) != getattr(want, key):
            raise AssertionError(f"{label}: {key} {getattr(config, key)!r} != "
                                 f"{getattr(want, key)!r}")


def _state_equal(got, want, label):
    """Two state dicts with the same keys and equal tensors (on the host),
    else raise."""
    if got.keys() != want.keys():
        raise AssertionError(f"{label}: keys differ: {sorted(set(got) ^ set(want))[:6]}")
    for k, t in got.items():
        w = want[k]
        if t.dtype != w.dtype or not torch.equal(t.cpu(), w.cpu()):
            raise AssertionError(f"{label}: {k} differs")


def import_llama_from_hf(init_inference, LlamaModel, cfg, accel, fa, da):
    """llama3.2-1b (the registry preset: Meta's published widths, llama3
    rope scaling, tied) as an HF-shaped dict built on the card, loaded by
    ``load_hf_model`` (a dict config) in bf16, its config held to the
    preset's, and served through ``init_inference`` → the graphed
    ``generate`` (``_served_cell``: B 32, prompt 128, 128 new, greedy; the
    ungraphed loop's tokens, the plain path's logits). The same weights
    served by a model of the preset's own config give the same tokens. →
    (launches, the served state dict, the HF config dict)."""
    from deepspeed_tpu_torch.module_inject.hf import load_hf_model

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    config, sd = hf_lm_state("llama", dataclasses.asdict(cfg), cfg.n_layer, gen)
    model, params = load_hf_model(_HFObject(config, sd), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del sd
    _config_held_to(model.config, cfg, ("vocab_size", "n_positions", "n_embd", "n_layer",
                                        "n_head", "n_kv_head", "intermediate_size",
                                        "rope_theta", "rope_scaling", "rms_norm_eps",
                                        "tie_embeddings"), f"load_hf_model {MODEL}")
    c = dataclasses.replace(model.config, use_flash_decode=True)
    t0 = time.perf_counter()
    engine = init_inference(LlamaModel(c), {"dtype": "bfloat16",
                                            "max_out_tokens": PROMPT + GEN}, params=params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    del params
    ids = torch.randint(0, c.vocab_size, (BATCH, PROMPT), generator=gen, device="cuda")
    label = f"import {MODEL} from hf"
    launches, loop, _, _ = _served_cell(engine, ids, accel, fa, da, label, hf_load_s=load_s,
                                        init_inference_s=init_s, nvidia_smi=nvidia_smi_line())
    with torch.inference_mode():
        tokens = engine.generate(ids, max_new_tokens=GEN)
    served = engine.module.state_dict()
    own = init_inference(LlamaModel(dataclasses.replace(cfg, use_flash_decode=True)),
                         {"dtype": "bfloat16", "max_out_tokens": PROMPT + GEN}, params=served)
    with torch.inference_mode():
        if not torch.equal(own.generate(ids, max_new_tokens=GEN), tokens):
            raise AssertionError(f"{label}: the preset's model on the same weights gave "
                                 "other greedy tokens")
    emit(f"{label} preset tokens", tokens_equal=True, batch=BATCH, prompt=PROMPT, gen=GEN)
    del engine, own, loop
    torch.cuda.empty_cache()
    return launches, served, config


def _bert_check_fp32(init_inference, BertModel, family, cfg, ids, fa):
    """2 layers of ``family`` at ``cfg``'s widths in fp32, loaded from an
    HF-shaped dict and served: the kernel path's MLM logits against the
    plain path's within 1e-4 of the largest. → (err, |ref| max)."""
    from deepspeed_tpu_torch.module_inject.hf import load_hf_model

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    config, sd = hf_lm_state(family, dataclasses.asdict(cfg), 2, gen, dtype=torch.float32)
    model, params = load_hf_model(_HFObject(config, sd), dtype=torch.float32)
    engine = init_inference(model, {"dtype": "float32"}, params=params)
    plain = BertModel(dataclasses.replace(model.config, use_flash_attention=False))
    plain.load_state_dict(engine.module.state_dict(), assign=True)
    with torch.inference_mode():
        got, ref = engine.forward(ids), plain.apply(ids)
    err, scale = max_err(got, ref), ref.abs().max().item()
    if not torch.isfinite(got).all() or err > 1e-4 * scale:
        raise AssertionError(f"fp32 2-layer {family}: kernel vs plain err {err}, |ref| {scale}")
    return err, scale


def import_bert_from_hf(init_inference, BertModel, name, family, cfg, accel, fa):
    """``name`` (bert-large or DistilBERT-base at their published widths) as an
    HF-shaped masked-LM dict built on the card, loaded by ``load_hf_model``
    in bf16 (its config held to ``cfg``) and served through
    ``init_inference``'s forward: MLM logits at 16 x 512, one non-causal K1
    per layer, against the plain path (LOGIT_RTOL of the largest logit),
    its ms per forward (median of SD_TIMED), and 2 fp32 layers against the
    plain path. → launches."""
    from deepspeed_tpu_torch.module_inject.hf import load_hf_model

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    config, sd = hf_lm_state(family, dataclasses.asdict(cfg), cfg.n_layer, gen)
    model, params = load_hf_model(_HFObject(config, sd), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del sd
    label = f"import {name} from hf"
    _config_held_to(model.config, cfg, ("vocab_size", "n_positions", "n_embd", "n_layer",
                                        "n_head", "intermediate_size", "type_vocab_size",
                                        "layer_norm_eps", "activation"), label)
    engine = init_inference(model, {"dtype": "bfloat16"}, params=params)
    del params
    rows, seq = IMPORT_BERT_SHAPE
    ids = torch.randint(0, cfg.vocab_size, (rows, seq), generator=gen, device="cuda")
    with torch.inference_mode():
        engine.forward(ids)                                    # warm-up
        fa.KERNEL.reset_launches()
        torch.cuda.synchronize()
        logits = engine.forward(ids)
        torch.cuda.synchronize()
        launches = {"flash_attention_fwd": fa.KERNEL.launches, "decode_attention": 0}
        if launches["flash_attention_fwd"] != cfg.n_layer:
            raise AssertionError(f"{label}: {launches} K1 launches for {cfg.n_layer} layers")
        ms, each = _median_ms(lambda: engine.forward(ids))
        plain = BertModel(dataclasses.replace(engine.module.config, use_flash_attention=False))
        plain.load_state_dict(engine.module.state_dict(), assign=True)
        ref = plain.apply(ids)
    err, scale = max_err(logits, ref), ref.abs().max().item()
    if tuple(logits.shape) != (rows, seq, cfg.vocab_size) or not torch.isfinite(logits).all() \
            or err > LOGIT_RTOL * scale:
        raise AssertionError(f"{label}: kernel vs plain err {err}, |ref| max {scale}")
    fp32_err, fp32_scale = _bert_check_fp32(init_inference, BertModel, family, cfg,
                                            ids[:2, :128], fa)
    emit(label, family=family, batch=rows, seq=seq, layers=cfg.n_layer, heads=cfg.n_head,
         head_dim=cfg.n_embd // cfg.n_head, dtype="bfloat16", launches=launches,
         forward_ms=ms, forward_ms_each=each, hf_load_s=load_s,
         logits_max_abs_err=err, ref_logits_max_abs=scale, logit_rtol=LOGIT_RTOL,
         top1_agree=(logits.argmax(-1) == ref.argmax(-1)).float().mean().item(),
         fp32_2layer_max_abs_err=fp32_err, fp32_2layer_ref_max_abs=fp32_scale,
         fp32_rtol=1e-4, nvidia_smi=nvidia_smi_line())
    del engine, plain, logits, ref
    torch.cuda.empty_cache()
    return launches


def export_round_trip(llama_sd, llama_config, gpt2_cfg):
    """``export_llama`` of the imported llama3.2-1b (2 of its 16 layers, its
    full width), ``export_gpt2`` of gpt2-760m and ``export_bloom`` of
    BLOOM-560m (full depth, random bf16 weights on the card), each read
    back by its loader: the same state dict bit for bit (the exporters widen
    bf16 to fp32 numpy, exactly)."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model
    from deepspeed_tpu_torch.module_inject import hf

    rows = {}
    keep = ("blocks.0.", "blocks.1.")
    sub = {k: v for k, v in llama_sd.items() if not k.startswith("blocks.") or k.startswith(keep)}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cases = (("llama3.2-1b (2 of 16 layers)", sub, hf.export_llama, hf.load_llama,
              llama_config),
             ("gpt2-760m", lambda: GPT2Model(gpt2_cfg).init_params(gen).to(
                 torch.bfloat16).state_dict(), hf.export_gpt2, hf.load_gpt2,
              {"model_type": "gpt2", "n_head": gpt2_cfg.n_head}),
             ("bloom-560m", lambda: GPT2Model(_variant_cfg("bloom-560m")).init_params(gen).to(
                 torch.bfloat16).state_dict(),
              lambda p: hf.export_bloom(p, n_head=VARIANT_MODELS["bloom-560m"]["n_head"]),
              hf.load_bloom, {"model_type": "bloom",
                              "n_head": VARIANT_MODELS["bloom-560m"]["n_head"]}))
    for label, src, export, load, config in cases:
        src = src() if callable(src) else src
        t0 = time.perf_counter()
        exported = export(src)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, back = load(_HFObject(config, exported), dtype=torch.bfloat16)
        load_s = time.perf_counter() - t0
        _state_equal(back, src, f"export round trip {label}")
        rows[label] = {"tensors": len(exported), "export_s": export_s, "load_s": load_s,
                       "params": sum(t.numel() for t in src.values()), "bitwise_equal": True}
        del exported, back, src
    torch.cuda.empty_cache()
    emit("export round trip", **rows)


def consolidate_llama_tag(save_dir, cfg):
    """``consolidate_to_file(arch="llama")`` of the llama3.2-1b stage-1 tag
    (its fp32 masters in the HF layout): its seconds and GB; the file read
    back by ``load_llama`` gives the preset's config, and its weights cast
    to bf16 are the tag's bf16 params, bit for bit."""
    from deepspeed_tpu_torch.module_inject.hf import load_llama
    from deepspeed_tpu_torch.runtime.checkpoint_engine.consolidate import consolidate_to_file
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import read_state

    out = os.path.join(os.path.dirname(save_dir), "llama_hf.npz")
    t0 = time.perf_counter()
    consolidate_to_file(save_dir, out, arch="llama")
    seconds = time.perf_counter() - t0
    nbytes = os.path.getsize(out)
    with open(os.path.join(save_dir, "latest")) as f:
        tag = read_state(os.path.join(save_dir, f.read().strip()), ("params",), "cpu")
    with np.load(out) as z:
        config, sd = load_llama(_HFObject(
            {"num_attention_heads": cfg.n_head, "rope_theta": cfg.rope_theta,
             "rope_scaling": cfg.rope_scaling, "rms_norm_eps": cfg.rms_norm_eps,
             "max_position_embeddings": cfg.n_positions}, {k: z[k] for k in z.files}))
    os.remove(out)
    _config_held_to(config, cfg, ("vocab_size", "n_embd", "n_layer", "n_head", "n_kv_head",
                                  "intermediate_size", "tie_embeddings"), "consolidate")
    _state_equal({k: v.to(torch.bfloat16) for k, v in sd.items()},
                 {k[len("params/"):]: v for k, v in tag.items()}, "consolidated llama")
    emit(f"consolidate {MODEL} arch llama", seconds=seconds, gb=nbytes / 1e9,
         gb_per_s=nbytes / 1e9 / seconds, tensors=len(sd), params_bitwise_equal_to_tag=True)


def serve_megatron(init_inference, name, kind, tp, accel, fa, da, tmp):
    """``name`` (gpt2-760m or gpt2-moe-125m at the registry's widths, random
    weights from the port's init on the card) written as a Megatron-DeepSpeed
    directory (fp16, ``tp`` shards, by the tests' ``write_megatron``: qkv
    rows in (head, 3, dh) order, column- and row-parallel weights split on
    dims 0 and 1, the experts in their own files) and served with ``init_inference(
    model=None, checkpoint=dir, checkpoint_config={"type": kind, "n_head":
    ...})`` in bf16: the model built from the files has the preset's widths
    and the written weights (bit for bit in bf16); ``_served_cell`` runs the
    counted graphed ``generate`` (B 32, prompt 128, 128 new) against the
    ungraphed loop and the plain path; the same weights served from the
    port's state dict by a model of the preset give the same tokens. →
    launches."""
    from deepspeed_tpu_torch.models.gpt2_moe import MoEGPT2
    from deepspeed_tpu_torch.models.registry import resolve_family
    from tests.torch_megatron_files import write_megatron

    cls, presets = resolve_family(name)
    cfg = presets[name]
    moe = kind == "Megatron-MoE"
    build = (lambda c: MoEGPT2(c, num_experts=MOE_EXPERTS, drop_tokens=False)) if moe \
        else cls
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sd = build(dataclasses.replace(cfg, remat=False)).init_params(gen).state_dict()
    out_dir = os.path.join(tmp, f"megatron_{name}")
    t0 = time.perf_counter()
    write_megatron({k: v.to(torch.float16).cpu() for k, v in sd.items()}, cfg.n_layer,
                   cfg.n_head, out_dir, tp=tp, moe=moe)
    write_s = time.perf_counter() - t0
    nbytes = _tree_bytes(out_dir)
    # the served weights: the files' fp16 values in bf16; a MoE block's dense
    # MLP is in no file (zeros, never used)
    want = {k: v.to(torch.float16).to(torch.bfloat16) for k, v in sd.items()}
    if moe:
        want.update({k: torch.zeros_like(v) for k, v in want.items()
                     if k.startswith("blocks.") and int(k.split(".")[1]) % 2
                     and ".fc" in k})
    del sd
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = init_inference(config={"checkpoint": out_dir, "dtype": "bfloat16",
                                    "max_out_tokens": PROMPT + GEN,
                                    "checkpoint_config": {"type": kind, "n_head": cfg.n_head}})
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    label = f"serve megatron {name}"
    _config_held_to(engine.module.config, cfg, ("vocab_size", "n_positions", "n_embd",
                                                 "n_layer", "n_head"), label)
    if moe and engine.module.num_experts != MOE_EXPERTS:
        raise AssertionError(f"{label}: {engine.module.num_experts} experts")
    _state_equal(engine.module.state_dict(), want, label)
    ids = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device="cuda")
    launches, loop, _, _ = _served_cell(
        engine, ids, accel, fa, da, label, checkpoint_type=kind, tp_files=tp,
        files_gb=nbytes / 1e9, write_s=write_s, load_s=load_s, params_bitwise_equal=True,
        nvidia_smi=nvidia_smi_line())
    with torch.inference_mode():
        tokens = engine.generate(ids, max_new_tokens=GEN)
    del engine, loop
    torch.cuda.empty_cache()
    direct = init_inference(build(dataclasses.replace(cfg, use_flash_decode=True)),
                            {"dtype": "bfloat16", "max_out_tokens": PROMPT + GEN}, params=want)
    with torch.inference_mode():
        if not torch.equal(direct.generate(ids, max_new_tokens=GEN), tokens):
            raise AssertionError(f"{label}: the port's state dict served other greedy tokens")
    emit(f"{label} state dict tokens", tokens_equal=True)
    del direct, want
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def import_slices(init_inference, LlamaModel, llama_cfg, BertModel, bert_cfg, gpt2_cfg, accel,
                  fa, da):
    """Model import: llama3.2-1b, bert-large and DistilBERT-base served from
    HF-shaped dicts, the exporters' round trips, and Megatron and
    Megatron-MoE directories served through ``checkpoint_config.type``. →
    launches by path."""
    launches = {}
    launches["import_llama_hf"], llama_sd, llama_config = import_llama_from_hf(
        init_inference, LlamaModel, llama_cfg, accel, fa, da)
    launches["import_bert_large_hf"] = import_bert_from_hf(
        init_inference, BertModel, BERT_MODEL, "bert", bert_cfg, accel, fa)
    launches["import_distilbert_hf"] = import_bert_from_hf(
        init_inference, BertModel, "distilbert-base", "distilbert",
        dataclasses.replace(bert_cfg, **DISTILBERT), accel, fa)
    export_round_trip(llama_sd, llama_config, gpt2_cfg)
    del llama_sd
    torch.cuda.empty_cache()
    root, _ = _scratch_dir()
    tmp = tempfile.mkdtemp(prefix="ds_megatron_", dir=root)
    try:
        launches["serve_megatron"] = serve_megatron(init_inference, TRAIN_MODEL, "Megatron", 2,
                                                    accel, fa, da, tmp)
        launches["serve_megatron_moe"] = serve_megatron(init_inference, MOE_MODEL,
                                                        "Megatron-MoE", 1, accel, fa, da, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ------------------------------------------------------------- RLHF actor
# the hybrid engine's phase: DeepSpeed-Chat's step-3 actor (OPT-1.3b, its
# training script's batch of 16 prompts of 256 tokens answered with 256 new
# tokens) at the published widths, bf16, ZeRO stage 2, remat "full"
HYBRID_MODEL = "opt-1.3b"
HYBRID_BATCH, HYBRID_PROMPT, HYBRID_GEN, HYBRID_ITERS = 16, 256, 256, 3
HYBRID_CONFIG = {"train_micro_batch_size_per_gpu": HYBRID_BATCH,
                 "gradient_accumulation_steps": 1,
                 "optimizer": {"type": "AdamW", "params": {"lr": 1e-5, "weight_decay": 0.0}},
                 "bf16": {"enabled": True}, "zero_optimization": {"stage": 2},
                 "gradient_clipping": 1.0, "steps_per_print": 0, "seed": SEED,
                 "hybrid_engine": {"enabled": True,
                                   "max_out_tokens": HYBRID_PROMPT + HYBRID_GEN}}
# the compression phase: MoQ 8 -> 4 bits on every block tensor (a stage
# every 2 steps from step 2: 4 bits from step 10) and l1 sparse pruning at
# dense ratio 0.5 from step 4, on the training cell's model and batch
COMPRESSION_STEPS = 12
COMPRESSION_BLOCK = {
    "weight_quantization": {
        "shared_parameters": {"enabled": True, "schedule_offset": 2, "quantization_period": 2},
        "different_groups": {"wq": {"params": {"start_bits": 8, "target_bits": 4},
                                    "modules": ["blocks"]}}},
    "sparse_pruning": {
        "shared_parameters": {"enabled": True, "schedule_offset": 4, "method": "l1"},
        "different_groups": {"sp": {"params": {"dense_ratio": 0.5}, "modules": ["blocks"]}}}}
# the eigenvalue phase: gpt2-760m's widths at 4 layers, micro batch 2 x 1024,
# 8 power iterations, the same MoQ block; its fp32 2-layer check against the
# CPU on 1 x 128 tokens from the same start vector
EIGEN_LAYERS, EIGEN_BATCH, EIGEN_STEPS = 4, 2, 3
EIGEN_BLOCK = {"enabled": True, "max_iter": 8, "tol": 1e-2, "gas_boundary_resolution": 1}
EIGEN_FP32 = dict(layers=2, batch=1, seq=128, rtol=1e-3)


def _k123(fa, da) -> dict:
    return {"flash_attention_fwd": fa.KERNEL.launches, **fa.BWD_KERNEL.entry_launches,
            "decode_attention": da.KERNEL.launches}


def _reset_k123(fa, da) -> None:
    for kern in (fa.KERNEL, fa.BWD_KERNEL, da.KERNEL):
        kern.reset_launches()


def hybrid_slice(initialize, init_inference, accel, fa, da):
    """DeepSpeed-Chat's actor loop on OPT-1.3b through the hybrid engine:
    HYBRID_ITERS times, graphed ``generate`` of 256 greedy tokens for 16
    prompts of 256 over the live params, then one ``train_batch`` on the 16
    x 512 sequences with the loss masked to the answers. Every generate's
    tokens equal the ungraphed loop's on the same live params bit for bit,
    one decode graph is captured for the whole run, and after a step the
    training model's prefill logits equal an ``InferenceEngine``'s over a
    copy of the updated params. Then the step's bf16 kernel-vs-plain check.
    → launches by path."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model

    c = _variant_cfg(HYBRID_MODEL, remat="full", use_flash_decode=True, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    engine, *_ = initialize(model=GPT2Model(c), config=json.loads(json.dumps(HYBRID_CONFIG)))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    prompts = torch.randint(0, c.vocab_size, (HYBRID_BATCH, HYBRID_PROMPT), generator=gen,
                            device="cuda")
    mask = torch.zeros(HYBRID_BATCH, HYBRID_PROMPT + HYBRID_GEN, device="cuda")
    mask[:, HYBRID_PROMPT:] = 1.0
    accel.reset_peak_memory_stats()
    rows, launches = [], {}
    for it in range(HYBRID_ITERS):
        t_it = time.perf_counter()
        _reset_k123(fa, da)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seqs = engine.generate(prompts, max_new_tokens=HYBRID_GEN)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        gen_launches = _k123(fa, da)
        want_k3 = c.n_layer * (HYBRID_GEN + (it == 0))       # the capture's warm-up step
        if gen_launches["flash_attention_fwd"] != c.n_layer or \
                gen_launches["decode_attention"] != want_k3:
            raise AssertionError(f"hybrid generate {it}: launches {gen_launches}, expected "
                                 f"{c.n_layer} K1 and {want_k3} K3")
        eager, eager_s = _eager_generate(engine, prompts, HYBRID_GEN)
        if not torch.equal(eager, seqs):
            raise AssertionError(f"hybrid generate {it}: graphed and ungraphed tokens differ "
                                 f"in {int((eager != seqs).sum().item())} places")
        _reset_k123(fa, da)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(engine.train_batch({"input_ids": seqs, "loss_mask": mask}))
        step_ms = (time.perf_counter() - t0) * 1e3
        train_launches = _k123(fa, da)
        want = {"flash_attention_fwd": 2 * c.n_layer, "flash_attention_bwd_dq": c.n_layer,
                "flash_attention_bwd_dkv": c.n_layer, "decode_attention": 0}
        if train_launches != want or not math.isfinite(loss):
            raise AssertionError(f"hybrid train {it}: launches {train_launches} (expected "
                                 f"{want}), loss {loss}")
        rows.append({"generate_s": gen_s, "generate_tok_s": HYBRID_BATCH * HYBRID_GEN / gen_s,
                     "eager_generate_s": eager_s, "train_step_ms": step_ms, "loss": loss,
                     "answer_distinct_tokens": int(torch.unique(seqs[:, HYBRID_PROMPT:]).numel()),
                     "alternation_s": time.perf_counter() - t_it - eager_s,
                     "generate_launches": gen_launches, "train_launches": train_launches})
        launches[f"hybrid_generate_{it}"] = gen_launches
        launches[f"hybrid_train_{it}"] = train_launches
    peak_gb = accel.max_memory_allocated() / 1e9
    stats = engine.hybrid_stats()
    if stats["captures"] != 1 or len(engine._decode_loops) != 1:
        raise AssertionError(f"hybrid decode graphs: {stats['captures']} captures, "
                             f"{len(engine._decode_loops)} loops for one key")
    # the updated params served by an inference engine over a copy of them
    params = {n: p.detach().clone() for n, p in engine.module.named_parameters()}
    served = init_inference(GPT2Model(c), {"dtype": "bfloat16",
                                           "max_out_tokens": HYBRID_PROMPT + HYBRID_GEN},
                            params=params)
    with torch.inference_mode():
        live, _ = engine.module.prefill(prompts, engine.module.init_cache(HYBRID_BATCH,
                                                                          HYBRID_PROMPT))
        copy, _ = served.module.prefill(prompts, served.module.init_cache(HYBRID_BATCH,
                                                                          HYBRID_PROMPT))
    if not torch.equal(live, copy):
        raise AssertionError(f"after {HYBRID_ITERS} steps the live params' prefill logits "
                             f"differ from an inference engine's over their copy by "
                             f"{max_err(live, copy)}")
    steady = rows[1:]
    emit(f"hybrid {HYBRID_MODEL}", layers=c.n_layer, width=c.n_embd, heads=c.n_head,
         head_dim=c.head_dim, batch=HYBRID_BATCH, prompt=HYBRID_PROMPT, gen=HYBRID_GEN,
         zero=2, remat="full", dtype="bfloat16", params=c.num_params(), init_s=init_s,
         iterations=rows, graphed_generate_tok_s=sum(r["generate_tok_s"] for r in steady)
         / len(steady), eager_generate_tok_s=sum(HYBRID_BATCH * HYBRID_GEN / r["eager_generate_s"]
                                                 for r in steady) / len(steady),
         train_step_ms=sum(r["train_step_ms"] for r in steady) / len(steady),
         alternation_s=sum(r["alternation_s"] for r in steady) / len(steady),
         captures=stats["captures"], capture_s=stats["capture_s"],
         hybrid_stats=stats, peak_mem_gb=peak_gb, graphed_equals_ungraphed=True,
         prefill_logits_equal_inference_engine=True, nvidia_smi=nvidia_smi_line())
    del engine, served, params
    torch.cuda.empty_cache()
    # the actor's step, kernel path against plain path in bf16 at full depth
    # on the last answers. No fp32 2-layer check of this model's step: its
    # gradients came 5.2e-4 apart in L2 on identical losses on an H100
    # (1.7e-6 with GELU in place of ReLU, 1.3e-6 for gpt2-760m), ReLU's kink
    # turning rounding-sized differences into flipped units
    train_check_bf16(GPT2Model, c, {"input_ids": seqs, "loss_mask": mask}, HYBRID_MODEL,
                     _dense_plain)
    return launches


def _stage_of(step: int) -> str:
    """The compression phase's stage at ``step`` (COMPRESSION_BLOCK)."""
    if step < 2:
        return "raw"
    bits = max(4, 8 - (step - 2) // 2)
    return f"{bits}bit" + ("+pruned" if step >= 4 else "")


def _armed(model, block, step):
    """``model`` reading its weights compressed by ``block`` at ``step``."""
    from deepspeed_tpu_torch.compression.compress import CompressedParams, init_compression

    transform = init_compression(model, {"compression_training": block})
    model.param_gatherer = CompressedParams(model, transform)
    model.param_gatherer.refresh(step)
    return transform


def compression_check_bf16(GPT2Model, cfg, batch):
    """gpt2-760m's bf16 step at the 5-bit pruned stage, kernel path against
    plain path on the same compressed weights: the loss and every gradient
    at the training check's limits."""
    model = GPT2Model(cfg).init_params(torch.Generator(device="cuda").manual_seed(SEED))
    model.to(dtype=torch.bfloat16)
    _armed(model, COMPRESSION_BLOCK, 8)
    loss_k, grads_k = _grads(model, batch)
    _dense_plain(model)
    loss_p, grads_p = _grads(model, batch)
    rel = {n: _rel_l2(grads_k[n], grads_p[n]) for n in grads_k}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    emit(f"train check {TRAIN_MODEL} compression bf16", layers=cfg.n_layer, step=8,
         stage=_stage_of(8), loss_kernel=loss_k.item(), loss_plain=loss_p.item(),
         loss_rel_diff=loss_rel, loss_rtol=TRAIN_LOSS_RTOL, grad_rel_l2_max=rel[worst],
         grad_rel_l2_worst=worst, grad_rtol=TRAIN_GRAD_RTOL)
    if not math.isfinite(loss_k.item()) or loss_rel > TRAIN_LOSS_RTOL \
            or rel[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError(f"compressed bf16 kernel path vs plain path: loss rel {loss_rel}, "
                             f"grad {worst} rel {rel[worst]}")
    del model, grads_k, grads_p
    torch.cuda.empty_cache()


def _cleaned_leaves(engine, keys=("qkv_w", "fc_w", "fc2_w", "proj_w")) -> dict:
    """Per stacked block leaf of the cleaned engine: its distinct values,
    zeros, the share at the smallest kept magnitude (the l1 threshold's
    ties) and the 4-bit transform's largest move of it in bf16 ulps."""
    named = dict(engine.module.named_parameters())
    L = engine.module.config.n_layer
    transform = engine._compression
    terminal = COMPRESSION_STEPS + 100
    eff, _ = transform.effective(named, terminal)
    out = {}
    for key in keys:
        w = torch.stack([named[f"blocks.{i}.{key}"].detach() for i in range(L)])
        again = torch.stack([eff[f"blocks.{i}.{key}"] for i in range(L)])
        mag = w.abs()
        ulp = torch.finfo(torch.bfloat16).eps * mag.clamp_min(torch.finfo(torch.bfloat16).tiny)
        out[key] = {"levels": int(torch.unique(w).numel()),
                    "zeros": (w == 0).float().mean().item(),
                    "threshold_ties": (mag == mag[mag > 0].min()).float().mean().item(),
                    "transform_moved": int((again != w).sum().item()),
                    "transform_max_ulps": ((again.float() - w.float()).abs() / ulp.float())
                    .max().item(),
                    "zeros_kept": bool(((w != 0) | (again == 0)).all().item())}
    return out


def compression_slice(initialize, GPT2Model, cfg, accel, fa):
    """The training cell under ``compression_training`` (COMPRESSION_BLOCK):
    COMPRESSION_STEPS steps through every MoQ stage and the pruning's start,
    each step's time by stage against the plain cell's; K1 and each K2 entry
    once per layer and step; ``redundancy_clean`` then leaves every block
    leaf with at most 2^4 levels (15: -7..7), half its entries zero less the
    ties the threshold keeps, and the terminal transform moves it by at most
    one bf16 rounding. Then the bf16 and fp32 2-layer kernel-vs-plain checks
    of the compressed path. → launches."""
    from deepspeed_tpu_torch.compression.compress import redundancy_clean
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    c = dataclasses.replace(cfg, remat=False)
    config = {**TRAIN_CONFIG, "compression_training": COMPRESSION_BLOCK}
    engine, *_ = initialize(model=GPT2Model(c), config=json.loads(json.dumps(config)))
    batch = synthetic_lm_batch(TRAIN_BATCH, TRAIN_SEQ, c.vocab_size, seed=SEED, device="cuda")
    accel.reset_peak_memory_stats()
    losses, step_ms, refresh_ms = [], [], []
    for kern in (fa.KERNEL, fa.BWD_KERNEL):
        kern.reset_launches()
    for step in range(COMPRESSION_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"flash_attention_fwd": fa.KERNEL.launches, **fa.BWD_KERNEL.entry_launches}
    expect = dict.fromkeys(launches, c.n_layer * COMPRESSION_STEPS)
    if launches != expect or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"compression steps: launches {launches} (expected {expect}), "
                             f"losses {losses}")
    # the refresh alone (the compressed weights of one step), timed
    for _ in range(3):
        engine.invalidate_compiled()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._refresh_compression()
        torch.cuda.synchronize()
        refresh_ms.append((time.perf_counter() - t0) * 1e3)
    peak_gb = accel.max_memory_allocated() / 1e9
    by_stage = {}
    for step, ms in enumerate(step_ms[1:], start=1):        # step 0 holds the first use
        by_stage.setdefault(_stage_of(step), []).append(ms)
    redundancy_clean(engine, {"compression_training": COMPRESSION_BLOCK})
    leaves = _cleaned_leaves(engine)
    for key, leaf in leaves.items():
        if leaf["levels"] > 2 ** 4 or not 0.5 - leaf["threshold_ties"] <= leaf["zeros"] <= 0.5 \
                or leaf["transform_max_ulps"] > 1.0 or not leaf["zeros_kept"]:
            raise AssertionError(f"redundancy_clean {key}: {leaf}")
    plain = LINES.get(f"train {TRAIN_MODEL}", {}).get("step_ms")
    emit(f"train {TRAIN_MODEL} compression", batch=TRAIN_BATCH, seq=TRAIN_SEQ, zero=1,
         layers=c.n_layer, steps=COMPRESSION_STEPS, losses=losses, step_ms_each=step_ms,
         step_ms_by_stage={s: sorted(v)[len(v) // 2] for s, v in by_stage.items()},
         plain_cell_step_ms=plain, refresh_ms=sorted(refresh_ms)[1],
         launches_per_step={k: v / COMPRESSION_STEPS for k, v in launches.items()},
         peak_mem_gb=peak_gb, cleaned=leaves, nvidia_smi=nvidia_smi_line())
    del engine
    torch.cuda.empty_cache()
    compression_check_bf16(GPT2Model, c, batch)
    early = json.loads(json.dumps(COMPRESSION_BLOCK))
    early["weight_quantization"]["shared_parameters"].update(schedule_offset=0,
                                                             quantization_period=1)
    early["sparse_pruning"]["shared_parameters"]["schedule_offset"] = 1
    train_check_fp32(initialize, GPT2Model, cfg, f"{TRAIN_MODEL} compression", TRAIN_SEQ,
                     {"compression_training": early}, _dense_plain)
    return launches


# the compression cell at ZeRO stage 3 (the blocks' weights fetched, the
# biases and gains in the persistent unit) over a NCCL group of one, with
# the telemetry trace, the goodput meter and the flops profiler (its count
# at GOODPUT_PROFILE_STEP gives MFU); then under offload_param: cpu for
# OFFLOAD_COMPRESSION_STEPS (MoQ's first stage at step 2, pruning's start at
# 4) beside OFFLOAD_BASE_STEPS of the same cell without the block, its
# extra peak at most twice the largest stacked leaf (24 x 1536 x 6144 bf16)
ZERO3_COMPRESSION = {"stage": 3}
GOODPUT_PROFILE_STEP = 2
GOODPUT_BUSY_STEPS = 2              # steps under the profiler, beside their ledgers
OFFLOAD_COMPRESSION_STEPS, OFFLOAD_BASE_STEPS = 6, 3
OFFLOAD_COMPRESSION_EXTRA_GB = 0.91


def _comm_spans(events) -> dict:
    """The comm layer's spans of a trace, each held to carry ``op``, ``seq``,
    ``group`` and ``bytes``, ``seq`` counting each (op, group) from 0. →
    spans by op and group."""
    seqs = {}
    for ev in events:
        if ev.get("cat") != "comm":
            continue
        a = ev.get("args") or {}
        if ev.get("ph") != "X" or ev.get("name") != f"comm:{a.get('op')}" \
                or not isinstance(a.get("seq"), int) or not a.get("group") \
                or not isinstance(a.get("bytes"), int) or a["bytes"] <= 0:
            raise AssertionError(f"a malformed comm span: {ev}")
        seqs.setdefault((a["op"], a["group"]), []).append(a["seq"])
    for key, seq in seqs.items():
        if seq != list(range(len(seq))):
            raise AssertionError(f"comm spans {key}: seq {seq[:8]}... does not count from 0")
    return {f"{op}@{group}": len(seq) for (op, group), seq in sorted(seqs.items())}


def _port_tool(main, *args) -> dict:
    """A command-line tool's ``main(args)`` in this process (the tools are
    standard library only; a process each would cost its start-up): exit
    code and output."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(args))
    if rc != 0:
        raise AssertionError(f"{main.__module__} {' '.join(args)} exited {rc}:\n"
                             f"{out.getvalue()[-2000:]}")
    return {"exit_code": rc, "stdout": out.getvalue().splitlines()}


def _losses_held(losses, ref, label) -> float:
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    if len(losses) > len(ref) or not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{label}: losses {losses} against the stage-1 cell's {ref}: "
                             f"rel {rel}")
    return rel


def compression_zero3_slice(initialize, GPT2Model, cfg, accel, fa, ref_losses, zero_losses):
    """The compression cell (COMPRESSION_BLOCK, COMPRESSION_STEPS) at ZeRO
    stage 3 over a NCCL group of one, with ``telemetry`` (the trace),
    ``goodput`` and the flops profiler: the losses within TRAIN_LOSS_RTOL
    of the stage-1 cell's; K1 and each K2 entry once per layer and step;
    every step's goodput buckets summing to its wall, timed apart (a
    synchronize, then the host clock around ``train_batch``), within the
    block's tolerance, and no closure violation; the comm spans well
    formed; the goodput fraction, top badput bucket and MFU beside the
    device's busy share of GOODPUT_BUSY_STEPS more steps under the
    profiler and their ledgers; ``profiling.cli goodput`` and ``goodput.top
    --once`` on the phase's directory. The drift's witness: the ZeRO
    phase's stage-3 and stage-1 losses without the block
    (``zero_losses``, by stage) beside this cell's and the stage-1 cell's,
    and at the steps before any technique applies this cell's losses
    equal to the stage-3 run's without the block bit for bit. → launches."""
    from deepspeed_tpu_torch import comm, telemetry
    from deepspeed_tpu_torch.goodput import top as goodput_top
    from deepspeed_tpu_torch.goodput.ledger import (goodput_fraction, step_ledgers,
                                                    sum_buckets, top_badput)
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch
    from deepspeed_tpu_torch.profiling import cli as profiling_cli

    c = dataclasses.replace(cfg, remat=False)
    root, _ = _scratch_dir()
    tmp = tempfile.mkdtemp(prefix="ds_goodput_", dir=root)
    tel = os.path.join(tmp, "telemetry")
    config = {**TRAIN_CONFIG, "zero_optimization": dict(ZERO3_COMPRESSION),
              "compression_training": COMPRESSION_BLOCK,
              "telemetry": {"enabled": True, "output_dir": tel,
                            "flush_interval": COMPRESSION_STEPS},
              "goodput": {},
              "flops_profiler": {"enabled": True, "profile_step": GOODPUT_PROFILE_STEP,
                                 "detailed": False,
                                 "output_file": os.path.join(tmp, "flops_profile.txt")}}
    comm.init_distributed(init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1,
                          timeout=600)
    try:
        engine, *_ = initialize(model=GPT2Model(c), config=json.loads(json.dumps(config)))
        fetched = sum(engine._zero.fetched)
        tolerance = engine._config.goodput.tolerance
        batch = synthetic_lm_batch(TRAIN_BATCH, TRAIN_SEQ, c.vocab_size, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        accel.reset_peak_memory_stats()
        _reset_counts(fa)
        losses, wall_ms = [], []
        for _ in range(COMPRESSION_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = engine.train_batch(batch)
            wall_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        launches = _kernel_counts(fa)
        peak_gb = accel.max_memory_allocated() / 1e9
        events = list(telemetry.get_tracer().events)
        snap = {(r["name"], tuple(sorted(r["labels"].items()))): r
                for r in telemetry.get_registry().snapshot()}
        refresh_ms = []
        for _ in range(3):
            engine.invalidate_compiled()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine._refresh_compression()
            torch.cuda.synchronize()
            refresh_ms.append((time.perf_counter() - t0) * 1e3)
        n0 = len(telemetry.get_tracer().events)
        busy = device_profile(lambda: [engine.train_batch(batch)
                                       for _ in range(GOODPUT_BUSY_STEPS)], top=8)
        busy_ledgers = step_ledgers(telemetry.get_tracer().events[n0:])
        served = sorted({t.device.type for t in engine._zero.served.values()})
        del engine
        telemetry.deconfigure()             # the trace and the metrics to disk
        tools = {"profiling.cli goodput": _port_tool(profiling_cli.main, "goodput", tel),
                 "goodput.top --once": _port_tool(goodput_top.main, tel, "--once")}
    finally:
        telemetry.deconfigure()
        comm.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    ledgers = step_ledgers(events)
    closure = [abs(sum(led["buckets"].values()) - ms * 1e3) / (ms * 1e3)
               for led, ms in zip(ledgers, wall_ms)]
    total = sum_buckets([led["buckets"] for led in ledgers])
    top = top_badput(total)
    busy_total = sum_buckets([led["buckets"] for led in busy_ledgers])
    gauge = lambda name, **labels: (snap.get((name, tuple(sorted(labels.items())))) or {}).get(
        "value")
    rel = _losses_held(losses, ref_losses, "compression at stage 3")
    per_step = lambda xs, ys: [abs(x - y) / abs(y) for x, y in zip(xs, ys)]
    raw = sum(_stage_of(s) == "raw" for s in range(COMPRESSION_STEPS))
    drift = {"raw_steps": raw,
             "raw_steps_equal_zero3_without_block": losses[:raw] == zero_losses[3][:raw],
             "zero3_vs_zero1_without_block": per_step(zero_losses[3], zero_losses[1]),
             "zero3_vs_zero1_compressed": per_step(losses, ref_losses)}
    expect = dict.fromkeys(launches, c.n_layer * COMPRESSION_STEPS)
    comm_spans = _comm_spans(events)
    emit(f"train {TRAIN_MODEL} compression zero3", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         zero=ZERO3_COMPRESSION, fetched_units=fetched, served_on=served, layers=c.n_layer,
         steps=COMPRESSION_STEPS, losses=losses, losses_stage1=ref_losses, loss_rel_diff=rel,
         rtol=TRAIN_LOSS_RTOL, drift_witness=drift, step_ms_each=wall_ms,
         step_ms=sorted(wall_ms[1:])[len(wall_ms[1:]) // 2],
         refresh_ms=sorted(refresh_ms)[1], peak_mem_gb=peak_gb,
         launches_per_step={k: v / COMPRESSION_STEPS for k, v in launches.items()},
         goodput_per_step=[{"step": led["step"], "wall_us": led["wall_us"],
                            "timed_wall_us": ms * 1e3, "closure_err": err,
                            "buckets_us": {b: v for b, v in led["buckets"].items() if v > 0}}
                           for led, ms, err in zip(ledgers, wall_ms, closure)],
         closure_max=max(closure), tolerance=tolerance,
         closure_violations=gauge("goodput/closure_violations") or 0,
         goodput_fraction=goodput_fraction(total), top_badput=top[0] if top else None,
         top_badput_share=top[1] / sum(total.values()) if top else 0.0,
         buckets_us=total, mfu=gauge("goodput/mfu"),
         flops_per_batch=gauge("train/flops_per_batch"),
         busy_steps=GOODPUT_BUSY_STEPS, busy_share=1.0 - busy["idle_share"],
         busy_steps_goodput_fraction=goodput_fraction(busy_total),
         busy_steps_buckets_us=busy_total, busy_profile=busy, comm_spans=comm_spans,
         tools=tools, nvidia_smi=nvidia_smi_line())
    if launches != expect or len(ledgers) != COMPRESSION_STEPS \
            or not drift["raw_steps_equal_zero3_without_block"]:
        raise AssertionError(f"compression at stage 3: launches {launches} (expected {expect}), "
                             f"{len(ledgers)} step ledgers, the raw steps' losses "
                             f"{losses[:raw]} against stage 3's without the block "
                             f"{zero_losses[3][:raw]}")
    if max(closure) > tolerance or (gauge("goodput/closure_violations") or 0) \
            or gauge("goodput/mfu") is None or not comm_spans or not fetched:
        raise AssertionError(f"compression at stage 3: goodput closure {closure} (tolerance "
                             f"{tolerance}), violations "
                             f"{gauge('goodput/closure_violations')}, MFU "
                             f"{gauge('goodput/mfu')}, comm spans {comm_spans}, "
                             f"{fetched} fetched units")
    compression_zero3_check_bf16(initialize, GPT2Model, c, batch)
    early = json.loads(json.dumps(COMPRESSION_BLOCK))
    early["weight_quantization"]["shared_parameters"].update(schedule_offset=0,
                                                             quantization_period=1)
    early["sparse_pruning"]["shared_parameters"]["schedule_offset"] = 1
    compression_zero3_check_fp32(initialize, GPT2Model, cfg, early)
    return launches


def compression_zero3_check_fp32(initialize, GPT2Model, cfg, block):
    """The engine's fp32 steps (:func:`_fp32_runs`) under ``block`` at ZeRO
    stage 3, every unit fetched: the kernel path against the plain path
    within FP32_RTOL, as train_check_fp32 holds them; and, the witness of
    the served compressed values, the kernel path at stage 3 against the
    same at stage 1, within FP32_RTOL (bit for bit where the arithmetic is
    the same)."""
    k = CHECK_FP32
    zero3 = {"stage": 3, "stage3_param_persistence_threshold": 0}
    runs = _fp32_runs(initialize, GPT2Model, cfg, TRAIN_SEQ, {
        "kernel": ({"compression_training": block, "zero_optimization": zero3}, None),
        "plain": ({"compression_training": block, "zero_optimization": zero3}, _dense_plain),
        "stage1": ({"compression_training": block, "zero_optimization": {"stage": 1}}, None)})
    got = _fp32_compare(runs, "kernel", "plain")
    stage1 = _fp32_compare(runs, "kernel", "stage1")
    emit(f"train check {TRAIN_MODEL} compression zero3 fp32 {k['layers']}-layer", seq=TRAIN_SEQ,
         **k, losses_kernel=runs["kernel"][0], losses_plain=runs["plain"][0], **got,
         losses_stage1=runs["stage1"][0], stage3_vs_stage1=stage1, rtol=FP32_RTOL)
    bad = {n: r for n, r in (("plain path", got), ("stage 1", stage1))
           if r["loss_rel_diff"] > FP32_RTOL or r["param_rel_l2"] > FP32_RTOL}
    if bad:
        raise AssertionError(f"fp32 compressed stage-3 kernel path against {bad}")
    del runs
    gc.collect()
    torch.cuda.empty_cache()


def compression_zero3_check_bf16(initialize, GPT2Model, c, batch):
    """The bf16 step at the 5-bit pruned stage (step 8) through a stage-3
    engine, whose fetched units hand out the compressed weights: the loss
    and every unit's gradient on the kernel path against the plain path on
    the same compressed weights, at the training check's limits."""
    config = {**TRAIN_CONFIG, "zero_optimization": {"stage": 3},
              "compression_training": COMPRESSION_BLOCK}
    model = GPT2Model(c)
    engine, *_ = initialize(model=model, config=json.loads(json.dumps(config)))
    engine._global_step = 8
    z = engine._zero
    runs = {}
    for path in ("kernel", "plain"):
        if path == "plain":
            _dense_plain(model)
        z.reset_grads()
        loss = engine.forward(batch)
        engine.backward(loss)
        runs[path] = (loss.detach().float().item(),
                      {engine._param_names[i]: z._shard_grads[p.unit][
                          p.offset:p.offset + p.numel].float().clone()
                       for i, p in enumerate(z.plan.params)})
    (loss_k, grads_k), (loss_p, grads_p) = runs["kernel"], runs["plain"]
    rel = {n: _rel_l2(grads_k[n], grads_p[n]) for n in grads_k}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    emit(f"train check {TRAIN_MODEL} compression zero3 bf16", layers=c.n_layer, step=8,
         stage=_stage_of(8), fetched_units=sum(z.fetched), loss_kernel=loss_k,
         loss_plain=loss_p, loss_rel_diff=loss_rel, loss_rtol=TRAIN_LOSS_RTOL,
         grad_rel_l2_max=rel[worst], grad_rel_l2_worst=worst, grad_rtol=TRAIN_GRAD_RTOL)
    if not math.isfinite(loss_k) or loss_rel > TRAIN_LOSS_RTOL or rel[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError(f"stage-3 compressed bf16 kernel path vs plain path: loss rel "
                             f"{loss_rel}, grad {worst} rel {rel[worst]}")
    del engine, model, runs, grads_k, grads_p
    gc.collect()
    torch.cuda.empty_cache()


def compression_offload_slice(initialize, GPT2Model, cfg, accel, fa, ref_losses):
    """The compression cell at ZeRO stage 3 with ``offload_param: cpu`` for
    OFFLOAD_COMPRESSION_STEPS, the compressed values served from pinned
    host memory: its losses within TRAIN_LOSS_RTOL of the stage-1 cell's
    first ones, K1 and each K2 entry once per layer and step, and its peak
    card memory at most OFFLOAD_COMPRESSION_EXTRA_GB above the same cell's
    without the block (OFFLOAD_BASE_STEPS), each peak taken above what
    was allocated when its steps began. → launches."""
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    c = dataclasses.replace(cfg, remat=False)
    batch = synthetic_lm_batch(TRAIN_BATCH, TRAIN_SEQ, c.vocab_size, seed=SEED, device="cuda")
    runs = {}
    gc.collect()                        # the earlier phases' engines, freed before either run
    for name, steps in (("plain", OFFLOAD_BASE_STEPS), ("compression", OFFLOAD_COMPRESSION_STEPS)):
        config = {**TRAIN_CONFIG, "zero_optimization": {"stage": 3,
                                                        "offload_param": {"device": "cpu"}}}
        if name == "compression":
            config["compression_training"] = COMPRESSION_BLOCK
        engine, *_ = initialize(model=GPT2Model(c), config=json.loads(json.dumps(config)))
        torch.cuda.synchronize()
        accel.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _reset_counts(fa)
        losses, step_ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        peak = accel.max_memory_allocated()
        run = {"losses": losses, "step_ms_each": step_ms, "launches": _kernel_counts(fa),
               "peak_mem_gb": peak / 1e9, "allocated_at_start_gb": base / 1e9,
               "peak_above_start_gb": (peak - base) / 1e9,
               "fetched_units": sum(engine._zero.fetched)}
        if name == "compression":
            refresh_ms = []
            for _ in range(3):
                engine.invalidate_compiled()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine._refresh_compression()
                torch.cuda.synchronize()
                refresh_ms.append((time.perf_counter() - t0) * 1e3)
            served = engine._zero.served.values()
            run.update(refresh_ms=sorted(refresh_ms)[1],
                       served_pinned=all(t.is_pinned() for t in served),
                       served_gb=sum(t.numel() * t.element_size() for t in served) / 1e9)
        runs[name] = run
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    got = runs["compression"]
    rel = _losses_held(got["losses"], ref_losses[:OFFLOAD_COMPRESSION_STEPS],
                       "compression under offload_param")
    extra = got["peak_above_start_gb"] - runs["plain"]["peak_above_start_gb"]
    expect = dict.fromkeys(got["launches"], c.n_layer * OFFLOAD_COMPRESSION_STEPS)
    emit(f"train {TRAIN_MODEL} compression offload", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         zero={"stage": 3, "offload_param": "cpu"}, layers=c.n_layer, runs=runs,
         losses_stage1=ref_losses[:OFFLOAD_COMPRESSION_STEPS], loss_rel_diff=rel,
         rtol=TRAIN_LOSS_RTOL, peak_extra_gb=extra,
         peak_extra_limit_gb=OFFLOAD_COMPRESSION_EXTRA_GB,
         launches_per_step={k: v / OFFLOAD_COMPRESSION_STEPS for k, v in got["launches"].items()},
         nvidia_smi=nvidia_smi_line())
    if got["launches"] != expect or not got["served_pinned"] \
            or extra > OFFLOAD_COMPRESSION_EXTRA_GB:
        raise AssertionError(f"compression under offload_param: launches {got['launches']} "
                             f"(expected {expect}), served pinned {got['served_pinned']}, "
                             f"{extra} GB above the cell without the block")
    return got["launches"]


def eigenvalue_check_fp32(GPT2Model, cfg):
    """gpt2-760m's widths at 2 layers in fp32: the block eigenvalues on the
    card against the CPU's plain run from the same start vectors."""
    from deepspeed_tpu_torch.models.common import plain_math
    from deepspeed_tpu_torch.runtime.eigenvalue import block_eigenvalues

    k = EIGEN_FP32
    c = dataclasses.replace(cfg, n_layer=k["layers"], remat=False, dtype=torch.float32)
    model = GPT2Model(c).init_params(torch.Generator(device="cuda").manual_seed(SEED + 2))
    ids = torch.randint(0, c.vocab_size, (k["batch"], k["seq"]),
                        generator=torch.Generator().manual_seed(SEED + 2))
    cpu = torch.Generator().manual_seed(SEED + 3)
    v0 = [{n.split(".", 2)[2]: torch.randn(p.shape, generator=cpu)
           for n, p in model.named_parameters() if n.startswith(f"blocks.{i}.")}
          for i in range(c.n_layer)]
    evs = {}
    for device in ("cuda", "cpu"):
        model.to(device)
        with plain_math(model):
            t0 = time.perf_counter()
            evs[device] = block_eigenvalues(lambda: model.loss({"input_ids": ids.to(device)}),
                                            dict(model.named_parameters()), max_iter=8,
                                            tol=1e-2, v0=v0).cpu()
            evs[device + "_s"] = time.perf_counter() - t0
    rel = ((evs["cuda"] - evs["cpu"]).abs() / evs["cpu"].abs()).max().item()
    emit(f"eigenvalue check {TRAIN_MODEL} fp32 {k['layers']}-layer", **k,
         card=evs["cuda"].tolist(), cpu=evs["cpu"].tolist(), rel_diff=rel,
         card_s=evs["cuda_s"], cpu_s=evs["cpu_s"])
    if not rel <= k["rtol"]:
        raise AssertionError(f"eigenvalues on the card {evs['cuda'].tolist()} against the "
                             f"CPU's {evs['cpu'].tolist()}: rel {rel}")
    del model
    torch.cuda.empty_cache()


def eigenvalue_slice(initialize, GPT2Model, cfg, accel, fa):
    """The eigenvalue block with the compression phase's MoQ on gpt2-760m's
    widths at EIGEN_LAYERS layers: after each ``train_batch`` the engine
    estimates each layer's eigenvalue on the first microbatch and installs
    MoQ's period factors. The estimate launches no K1 or K2 (plain
    attention: the kernels have no double backward) and the train step its
    own counts; the estimate's ms and peak. Then the fp32 2-layer estimate
    against the CPU. → the train steps' launches."""
    from deepspeed_tpu_torch.models.gpt2 import synthetic_lm_batch

    c = dataclasses.replace(cfg, n_layer=EIGEN_LAYERS, remat=False)
    config = {**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": EIGEN_BATCH,
              "compression_training": COMPRESSION_BLOCK, "eigenvalue": EIGEN_BLOCK}
    engine, *_ = initialize(model=GPT2Model(c), config=json.loads(json.dumps(config)))
    batch = synthetic_lm_batch(EIGEN_BATCH, TRAIN_SEQ, c.vocab_size, seed=SEED, device="cuda")
    estimate = engine._maybe_update_eigenvalue
    runs, steps = [], []
    counts = lambda: {"flash_attention_fwd": fa.KERNEL.launches, **fa.BWD_KERNEL.entry_launches}

    def measured(b):
        # the step's own launches (counted from 0 before its train_batch),
        # then the estimate's from 0
        steps.append(counts())
        for kern in (fa.KERNEL, fa.BWD_KERNEL):
            kern.reset_launches()
        torch.cuda.synchronize()
        accel.reset_peak_memory_stats()
        t0 = time.perf_counter()
        estimate(b)
        torch.cuda.synchronize()
        runs.append({"ms": (time.perf_counter() - t0) * 1e3, "launches": counts(),
                     "peak_mem_gb": accel.max_memory_allocated() / 1e9,
                     "eigenvalues": [ev for ev, _ in (engine.block_eigenvalue or {}).values()],
                     "factors": list(engine._compression._ev_factors or ())})

    engine._maybe_update_eigenvalue = measured
    losses = []
    for _ in range(EIGEN_STEPS):
        for kern in (fa.KERNEL, fa.BWD_KERNEL):
            kern.reset_launches()
        losses.append(float(engine.train_batch(batch)))
    own = dict.fromkeys(("flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv"), EIGEN_LAYERS)
    if any(step != own for step in steps) or any(any(r["launches"].values()) for r in runs) \
            or len(runs) != EIGEN_STEPS or not runs[-1]["factors"] \
            or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"eigenvalue phase: estimates {runs}, train steps' launches "
                             f"{steps} (expected {own} each), losses {losses}")
    emit(f"eigenvalue {TRAIN_MODEL}", layers=EIGEN_LAYERS, batch=EIGEN_BATCH, seq=TRAIN_SEQ,
         max_iter=EIGEN_BLOCK["max_iter"], estimates=runs,
         estimate_ms=sorted(r["ms"] for r in runs)[len(runs) // 2],
         train_step_launches=steps, losses=losses, nvidia_smi=nvidia_smi_line())
    del engine
    torch.cuda.empty_cache()
    eigenvalue_check_fp32(GPT2Model, cfg)
    return {k: v * EIGEN_STEPS for k, v in own.items()}


def rlhf_slices(initialize, init_inference, GPT2Model, gpt2_cfg, accel, fa, da, zero_losses):
    """The RLHF actor's path: the hybrid engine on OPT-1.3b, compression
    training (at stage 1, at stage 3 with the goodput meter, under
    offload_param) and the eigenvalue on gpt2-760m; ``zero_losses``, the
    ZeRO phase's losses by stage, witness the stage-3 cell's drift. →
    launches by path."""
    launches = hybrid_slice(initialize, init_inference, accel, fa, da)
    launches["train_compression"] = compression_slice(initialize, GPT2Model, gpt2_cfg, accel, fa)
    stage1 = LINES[f"train {TRAIN_MODEL} compression"]["losses"]
    launches["train_compression_zero3"] = compression_zero3_slice(
        initialize, GPT2Model, gpt2_cfg, accel, fa, stage1, zero_losses)
    launches["train_compression_offload"] = compression_offload_slice(
        initialize, GPT2Model, gpt2_cfg, accel, fa, stage1)
    launches["train_eigenvalue"] = eigenvalue_slice(initialize, GPT2Model, gpt2_cfg, accel, fa)
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
         seconds_by_kernel={k.name: k.build_seconds for k in all_kernels},
         ptxas={k.name: ptxas_summary(k.build_log) for k in all_kernels})

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf, f32 = torch.bfloat16, torch.float32
    f16 = torch.float16
    # the 64-row tiles' edges: T = 1, 63, 64, 65, 127, 200, 1000, Tq != Tk, and
    # D 64 / 96 / 128 in bf16 and fp16; the curriculum phase's lengths below 1024
    ragged = sorted(set(curriculum_lengths()) - {TRAIN_SEQ})
    # the rows the kernels' summary reports are timed (the first of each
    # list, the model and SD-1.5 shapes, the head dim 256 rows); the edge,
    # type and head-dim rows after them are held to their plain versions
    # without a time
    flash_rows = [check_flash(fa, accel, gen, *case) for case in (
        ("train", TRAIN_BATCH, TRAIN_SEQ, 16, 96, bf, True),
        ("slice", BATCH, PROMPT, 32, 64, bf, True))]
    with untimed():
        flash_rows += [check_flash(fa, accel, gen, *case) for case in (
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
    bwd_rows = [check_flash_bwd(fa, accel, gen, "train", BH, TRAIN_SEQ, 96, bf, True)]
    with untimed():
        bwd_rows += [check_flash_bwd(fa, accel, gen, *case) for case in (
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
    # the llama, MoE, pythia and BERT training phases' shapes: causal at
    # llama3.2-1b's 4 x 2048 (32 heads of 64 after the KV heads' repeat) and
    # pythia-1.4b's (16 heads of 128), non-causal at
    # bert-large's 64 x 128 and 16 x 512 (16 heads of 64), bf16 and fp16;
    # held to their plain versions without a time (their times: PERF.md)
    with untimed():
        model_fwd = {row["name"]: row for row in (
            check_flash(fa, accel, gen, *case) for case in (
            ("llama_train", LLAMA_BATCH, LLAMA_SEQ, 32, 64, bf, True),
            ("moe_train", MOE_BATCH, MOE_SEQ, 12, 64, bf, True),
            ("pythia_train", PYTHIA_BATCH, PYTHIA_SEQ, 16, 128, bf, True),
            *((f"bert_s{t}{suffix}", b, t, 16, 64, dt, False)
              for b, t, _ in BERT_SHAPES for suffix, dt in (("", bf), ("_fp16", f16))),
            # the model-import phases' new shapes: DistilBERT-base's MLM forward
            # (12 heads of 64, non-causal) and gpt2-760m's serving prefill
            ("distilbert_s512", *IMPORT_BERT_SHAPE, 12, 64, bf, False),
            ("gpt2_prefill_d96", BATCH, PROMPT, 16, 96, bf, True),
            # the hybrid engine's OPT-1.3b: its prefill and its train step
            ("opt_prefill", HYBRID_BATCH, HYBRID_PROMPT, 32, 64, bf, True),
            ("opt_train", HYBRID_BATCH, HYBRID_PROMPT + HYBRID_GEN, 32, 64, bf, True)))}
        model_bwd = {row["name"]: row for row in (
            check_flash_bwd(fa, accel, gen, *case) for case in (
            ("llama_train", LLAMA_BATCH * 32, LLAMA_SEQ, 64, bf, True),
            ("moe_train", MOE_BATCH * 12, MOE_SEQ, 64, bf, True),
            ("pythia_train", PYTHIA_BATCH * 16, PYTHIA_SEQ, 128, bf, True),
            ("opt_train", HYBRID_BATCH * 32, HYBRID_PROMPT + HYBRID_GEN, 64, bf, True),
            *((f"bert_s{t}{suffix}", b * 16, t, 64, dt, False)
              for b, t, _ in BERT_SHAPES for suffix, dt in (("", bf), ("_fp16", f16)))))}
    # SD-1.5's shapes: the UNet's self-attention (T = H W) and cross-attention
    # (77 context keys) at head dims 40, 80 and 160 over a 64 x 64 latent with
    # classifier-free guidance (B = 4, 8 heads), the VAE's mid attention at
    # head dim 512 (the decode's B = 2, the round trip's B = 1), CLIP's causal
    # T = 77; bf16, and one fp16 and one fp32 row per new head dim
    sd_fwd = {row["name"]: row for row in (
        _checked(check_flash, case[0], fa, accel, gen, *case) for case in (
        ("sd_unet_self_d40", 4, 4096, 8, 40, bf, False),
        ("sd_unet_cross_d40", 4, 4096, 8, 40, bf, False, SD_TOKENS),
        ("sd_unet_self_d80", 4, 1024, 8, 80, bf, False),
        ("sd_unet_cross_d80", 4, 1024, 8, 80, bf, False, SD_TOKENS),
        ("sd_unet_self_d160", 4, 256, 8, 160, bf, False),
        ("sd_unet_cross_d160", 4, 256, 8, 160, bf, False, SD_TOKENS),
        ("sd_unet_mid_self_d160", 4, 64, 8, 160, bf, False),
        ("sd_unet_mid_cross_d160", 4, 64, 8, 160, bf, False, SD_TOKENS),
        ("sd_vae_decode_d512", SD_PROMPTS, 4096, 1, 512, bf, False),
        ("sd_vae_round_trip_d512", 1, 4096, 1, 512, bf, False),
        ("sd_clip_d64", 2 * SD_PROMPTS, SD_TOKENS, 12, 64, bf, True),
        ("sd_unet_self_d40_fp16", 4, 4096, 8, 40, f16, False),
        ("sd_unet_self_d160_fp16", 4, 256, 8, 160, f16, False),
        ("sd_vae_decode_d512_fp16", SD_PROMPTS, 4096, 1, 512, f16, False),
        ("sd_unet_self_d40_fp32", 4, 4096, 8, 40, f32, False),
        ("sd_unet_self_d160_fp32", 4, 256, 8, 160, f32, False),
        ("sd_vae_decode_d512_fp32", SD_PROMPTS, 4096, 1, 512, f32, False),
        # the forward-only head dims at tile edges, causal, with Tq != Tk
        *((f"sd_edges_d{d}_tq65_tk7", 2, 65, 2, d, bf, True, 7) for d in (40, 160, 512))))}
    # GPT-J-6B's head dim 256 (forward only): K1 at B 4 x T 2048 (16 heads,
    # causal and not), at its serving prefill (B 32 x 128), in fp16 and fp32,
    # and at tile edges with Tq != Tk
    gptj_fwd = {row["name"]: row for row in (
        _checked(check_flash, case[0], fa, accel, gen, *case) for case in (
        ("gptj_d256", 4, 2048, 16, 256, bf, True),
        ("gptj_d256_noncausal", 4, 2048, 16, 256, bf, False),
        ("gptj_prefill_d256", BATCH, PROMPT, 16, 256, bf, True),
        ("gptj_d256_fp16", 4, 2048, 16, 256, f16, True),
        ("gptj_d256_fp32", 2, 512, 16, 256, f32, True),
        ("gptj_d256_fp32_noncausal", 2, 512, 16, 256, f32, False),
        ("gptj_edges_d256_tq65_tk7", 2, 65, 2, 256, bf, True, 7)))}
    S = PROMPT + GEN
    # and K3 at GPT-J-6B's serving shape (B 32, S 256, H = KV = 16), its
    # first slot, fp16 and fp32, and over an 8192-entry cache (the merge)
    gptj_decode = {row["name"]: row for row in (
        _checked(check_decode, case[0], da, accel, gen, *case) for case in (
        ("gptj_d256", BATCH, S, 16, 16, 256, bf, S - 1),
        ("gptj_d256_pos0", BATCH, S, 16, 16, 256, bf, 0),
        ("gptj_d256_fp16", BATCH, S, 16, 16, 256, f16, S - 1),
        ("gptj_d256_fp32", BATCH, S, 16, 16, 256, f32, S - 1),
        ("gptj_d256_long", LONG_BATCH, LONG_S, 16, 16, 256, bf, LONG_S - 1)))}
    decode_rows = [check_decode(da, accel, gen, "slice_pos255", BATCH, S, 32, 8, 64, bf, S - 1)]
    with untimed():
        decode_rows += [check_decode(da, accel, gen, *case) for case in (
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
    # the serving front-end's shapes: one sequence at a time (B = 1), its
    # prefill at T = PROMPT and its decode over a cache of max_out_tokens
    # (S = PROMPT + GEN) with pos mid-cache; bf16 timed, fp32 held untimed
    frontend_fwd = check_flash(fa, accel, gen, "frontend_b1", 1, PROMPT, 32, 64, bf, True)
    frontend_decode = check_decode(da, accel, gen, "frontend_b1_pos150", 1, S, 32, 8, 64, bf,
                                   150)
    with untimed():
        check_flash(fa, accel, gen, "frontend_b1_fp32", 1, PROMPT, 32, 64, f32, True)
        check_decode(da, accel, gen, "frontend_b1_pos150_fp32", 1, S, 32, 8, 64, f32, 150)
    # gpt2-760m's serving shape: one query head per KV head (MHA), head dim 96
    gpt2_decode_rows = [check_decode(da, accel, gen, *case) for case in (
        ("gpt2_mha_d96", BATCH, S, 16, 16, 96, bf, S - 1),
        ("gpt2_mha_d96_fp16", BATCH, S, 16, 16, 96, f16, S - 1))]
    # the hybrid engine's OPT-1.3b decode: 32 heads of 64, one per KV head,
    # over its 512-entry cache
    opt_decode_row = check_decode(da, accel, gen, "opt_mha_d64", HYBRID_BATCH,
                                  HYBRID_PROMPT + HYBRID_GEN, 32, 32, 64, bf,
                                  HYBRID_PROMPT + HYBRID_GEN - 1)
    # gpt2-moe-125m's serving shape: 12 heads of 64, one per KV head
    moe_decode_row = check_decode(da, accel, gen, "moe_mha_d64", BATCH, S, 12, 12, 64, bf,
                                  S - 1)
    # the long caches the split is for, its chunks' edges, and the other types
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    long_chunk = da.decode_chunk(LONG_BATCH, 8, LONG_S, n_sm)
    long_rows = [check_decode(da, accel, gen, "long_b4_s8192", LONG_BATCH, LONG_S, 32, 8, 64, bf,
                              LONG_S - 1)]
    with untimed():
        long_rows += [check_decode(da, accel, gen, *case) for case in (
            ("long_b1_s32768_pos20000", 1, 32768, 32, 8, 64, bf, 20000),
            ("long_pos_chunk_last", LONG_BATCH, LONG_S, 32, 8, 64, bf, long_chunk - 1),
            ("long_pos_chunk_first", LONG_BATCH, LONG_S, 32, 8, 64, bf, long_chunk),
            ("long_fp32", LONG_BATCH, LONG_S, 32, 8, 64, f32, LONG_S - 1),
            ("long_fp16", LONG_BATCH, LONG_S, 32, 8, 64, f16, LONG_S - 1),
            ("long_mqa", LONG_BATCH, LONG_S, 32, 1, 64, bf, LONG_S - 1))]
        long_rows.append(check_decode(da, accel, gen, "long_garbage_past_pos", LONG_BATCH,
                                      LONG_S, 32, 8, 64, bf, 5000, garbage=True))
    from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config
    # the training cell's row is timed; the other layouts, blocks, head dims
    # and types are held to their plain versions without a time
    cases = sparse_cases(fa, sparsity_config)
    sparse_rows = [check_sparse(fa, accel, gen, *cases[0])]
    with untimed():
        sparse_rows += [check_sparse(fa, accel, gen, *case) for case in cases[1:]]
    # gpt2-moe-125m's sparse training shape: 12 x 1024, 12 heads of 64, the
    # same fixed layout
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention
    moe_sparse_row = check_sparse(fa, accel, gen, "moe_train_fixed16", MOE_BATCH * 12, MOE_SEQ,
                                  64, bf, sparse_self_attention(SPARSE_BLOCK, 12)
                                  .get_layout(MOE_SEQ), True)

    model_cls, presets = resolve_family(MODEL)
    serve_launches, frontend_launches = serve_slice(deepspeed_tpu_torch.init_inference,
                                                    model_cls, presets[MODEL], accel, fa, da)
    # weight-quantized serving of the same model: int8, then int4
    quant_launches = {f"serve_int{bits}": serve_quantized(
        deepspeed_tpu_torch.init_inference, model_cls, presets[MODEL], accel, fa, da, bits)
        for bits in (8, 4)}
    serve_small_fp32(deepspeed_tpu_torch.init_inference, model_cls, presets[MODEL])
    serve_small_fp16(deepspeed_tpu_torch.init_inference, model_cls, presets[MODEL], fa, da)
    serve_sampled(deepspeed_tpu_torch.init_inference, model_cls, presets[MODEL], da)
    serve_long(deepspeed_tpu_torch.init_inference, model_cls, presets[MODEL], fa, da)

    gpt2_cls, gpt2_presets = resolve_family(TRAIN_MODEL)
    train_launches, batch, train_losses, unarmed_losses = train_slice(
        deepspeed_tpu_torch.initialize, gpt2_cls, gpt2_presets[TRAIN_MODEL], accel, fa)
    ac_launches = train_activation_checkpointing(deepspeed_tpu_torch.initialize, gpt2_cls,
                                                 gpt2_presets[TRAIN_MODEL], accel, fa,
                                                 train_losses, batch)
    train_check_bf16(gpt2_cls, dataclasses.replace(gpt2_presets[TRAIN_MODEL], remat=False),
                     batch, TRAIN_MODEL, _dense_plain)
    train_check_fp32(deepspeed_tpu_torch.initialize, gpt2_cls, gpt2_presets[TRAIN_MODEL],
                     TRAIN_MODEL, TRAIN_SEQ, {}, _dense_plain)
    # the training cell under the watchdog, the sentinel and the RAM ring,
    # then the hang, loss-spike and preempt drills under the elastic agent
    resilience_launches = resilience_slices(
        deepspeed_tpu_torch.initialize, gpt2_cls, gpt2_presets[TRAIN_MODEL], accel, fa,
        unarmed_losses, LINES[f"train {TRAIN_MODEL}"]["step_ms"])
    # the training cell under the monitor, the telemetry fan-out and both
    # profilers
    resilience_launches["profiled"] = profiled_slice(
        deepspeed_tpu_torch.initialize, gpt2_cls, gpt2_presets[TRAIN_MODEL], accel, fa,
        unarmed_losses, LINES[f"train {TRAIN_MODEL}"]["step_ms"])
    zero_launches, zero_losses, zero_step_ms = zero_slice(
        deepspeed_tpu_torch.initialize, gpt2_cls, gpt2_presets[TRAIN_MODEL], accel, fa)
    launch_launches = launch_slices(gpt2_presets[TRAIN_MODEL], zero_losses[1], zero_step_ms[1])

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
    resume_launches, curriculum_launches, serve_gpt2_launches = data_and_checkpoint_slices(
        deepspeed_tpu_torch.initialize, deepspeed_tpu_torch.init_inference, gpt2_cls,
        gpt2_presets[TRAIN_MODEL], accel, fa, da)
    offload_launches = offload_slices(deepspeed_tpu_torch.initialize, gpt2_cls, gpt2_presets,
                                      accel, fa)
    # launches per offload path: the five gpt2-2.7b runs, gpt2-6.7b, the NVMe runs
    by_offload = {f"offload_{k}": v for k, v in offload_launches["offload"].items()}
    by_offload["offload_capacity"] = offload_launches["capacity"]
    by_offload.update({f"nvme_{k}": v for k, v in offload_launches["nvme"].items()})
    # the llama and BERT training phases, and llama3.2-1b served from its tag
    model_launches = llama_train_slices(deepspeed_tpu_torch.initialize,
                                        deepspeed_tpu_torch.init_inference, model_cls,
                                        presets[MODEL], accel, fa, da)
    bert_cls, bert_presets = resolve_family(BERT_MODEL)
    model_launches.update(bert_train_slices(deepspeed_tpu_torch.initialize, bert_cls,
                                            bert_presets[BERT_MODEL], accel, fa))
    moe_cls, moe_presets = resolve_family(MOE_MODEL)
    model_launches.update(moe_train_slices(deepspeed_tpu_torch.initialize,
                                           deepspeed_tpu_torch.init_inference, moe_cls,
                                           moe_presets[MOE_MODEL], accel, fa, da))
    moe_sparse_launches = model_launches.pop("train_moe_sparse")
    served = ("serve_llama_tag", "serve_moe_tag")
    trained = {p: n for p, n in model_launches.items() if p not in served}
    # SD-1.5 served at full width: CLIP, the UNet and the VAE
    sd_calls = sd_slices(deepspeed_tpu_torch.init_inference, accel, fa, all_kernels)
    sd_launches = sum(sd_calls.values())
    # the GPT-2 variant families: pythia-1.4b trained under three remat
    # policies, pythia, OPT, GPT-Neo, BLOOM and GPT-J served, bert-large PLD
    variant_launches = variant_slices(deepspeed_tpu_torch.initialize,
                                      deepspeed_tpu_torch.init_inference, bert_cls,
                                      bert_presets[BERT_MODEL], accel, fa, da)
    variant_trained = {p: n for p, n in variant_launches.items() if p.startswith("train")}
    variant_served = {p: n for p, n in variant_launches.items() if p not in variant_trained}
    # model import: llama3.2-1b, bert-large and DistilBERT from HF-shaped
    # dicts, the exporters' round trips, Megatron and Megatron-MoE directories
    import_launches = import_slices(deepspeed_tpu_torch.init_inference, model_cls,
                                    presets[MODEL], bert_cls, bert_presets[BERT_MODEL],
                                    gpt2_presets[TRAIN_MODEL], accel, fa, da)
    # the RLHF actor: the hybrid engine on OPT-1.3b, compression training and
    # the eigenvalue on gpt2-760m
    rlhf_launches = rlhf_slices(deepspeed_tpu_torch.initialize, deepspeed_tpu_torch.init_inference,
                                gpt2_cls, gpt2_presets[TRAIN_MODEL], accel, fa, da,
                                zero_losses)
    rlhf_trained = {p: n for p, n in rlhf_launches.items() if "generate" not in p}
    rlhf_generated = {p: n for p, n in rlhf_launches.items() if "generate" in p}

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    bwd = bwd_rows[0]
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:123",
         "launches": train_launches["flash_attention_fwd"],
         **{k: flash_rows[0][k] for k in keys},
         "launches_by_path": {"serve": serve_launches["flash_attention_fwd"],
                              "serve_frontend": frontend_launches["flash_attention_fwd"],
                              "serve_gpt2": serve_gpt2_launches["flash_attention_fwd"],
                              **{p: n["flash_attention_fwd"]
                                 for p, n in quant_launches.items()},
                              "train": train_launches["flash_attention_fwd"],
                              "train_activation_checkpointing":
                                  ac_launches["flash_attention_fwd"],
                              "launch": launch_launches["flash_attention_fwd"],
                              "resume": resume_launches["flash_attention_fwd"],
                              "curriculum": curriculum_launches["flash_attention_fwd"],
                              **{f"zero{s}": n["flash_attention_fwd"]
                                 for s, n in zero_launches.items()},
                              **{p: n["flash_attention_fwd"] for p, n in by_offload.items()},
                              **{p: n["flash_attention_fwd"]
                                 for p, n in model_launches.items()},
                              "serve_sd15": sd_launches,
                              **{p: n["flash_attention_fwd"]
                                 for p, n in variant_launches.items()},
                              **{p: n["flash_attention_fwd"]
                                 for p, n in import_launches.items()},
                              **{p: n["flash_attention_fwd"] for p, n in rlhf_launches.items()},
                              **{p: n["flash_attention_fwd"]
                                 for p, n in resilience_launches.items()}},
         "at_serving_shape": {k: flash_rows[1][k] for k in keys},
         "at_frontend_shape": {k: frontend_fwd[k] for k in keys},
         "at_model_shapes": {name: {k: row[k] for k in keys} for name, row in model_fwd.items()}},
        {"name": "decode_attention", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
         "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:47",
         "launches": serve_launches["decode_attention"],
         **{k: decode_rows[0][k] for k in keys},
         "launches_by_path": {"serve": serve_launches["decode_attention"],
                              "serve_frontend": frontend_launches["decode_attention"],
                              **{p: n["decode_attention"] for p, n in quant_launches.items()},
                              "serve_gpt2": serve_gpt2_launches["decode_attention"],
                              **{p: model_launches[p]["decode_attention"] for p in served},
                              **{p: n["decode_attention"] for p, n in variant_served.items()},
                              **{p: n["decode_attention"] for p, n in import_launches.items()
                                 if n["decode_attention"]},
                              **{p: n["decode_attention"] for p, n in rlhf_generated.items()}},
         "at_opt_serving_shape": {k: opt_decode_row[k] for k in keys},
         "at_frontend_shape": {k: frontend_decode[k] for k in keys},
         "at_long_shape": {k: long_rows[0][k] for k in keys},
         "at_gpt2_mha_shape": {k: gpt2_decode_rows[0][k] for k in keys},
         "at_moe_serving_shape": {k: moe_decode_row[k] for k in keys}},
    ]
    for entry, replaces in (("dq", "deepspeed_tpu/ops/pallas/flash_attention.py:287"),
                            ("dkv", "deepspeed_tpu/ops/pallas/flash_attention.py:313")):
        kernels.append({
            "name": f"flash_attention_bwd_{entry}", "route": "cuda",
            "source": "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu", "replaces": replaces,
            "launches": train_launches[f"flash_attention_bwd_{entry}"],
            "launches_by_path": {p: n[f"flash_attention_bwd_{entry}"] for p, n in (
                ("train", train_launches), ("train_activation_checkpointing", ac_launches),
                ("launch", launch_launches),
                ("resume", resume_launches),
                ("curriculum", curriculum_launches),
                *((f"zero{s}", z) for s, z in zero_launches.items()),
                *by_offload.items(), *trained.items(), *variant_trained.items(),
                *rlhf_trained.items(), *resilience_launches.items())},
            "at_model_shapes": {name: {
                "max_abs_err": max(row["errs"][n] for n in (("dq",) if entry == "dq"
                                                            else ("dk", "dv"))),
                **{k: row[f"{entry}_{k}"] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                "library_pair_bwd_ms": row["library_bwd_ms"]} for name, row in model_bwd.items()},
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
            "launches_by_path": {"train": sparse_launches[name],
                                 "train_moe_sparse": moe_sparse_launches[name]},
            "at_moe_shape": {
                "max_abs_err": moe_sparse_row["max_abs_err"] if entry == "fwd" else max(
                    moe_sparse_row["grad_errs"][g] for g in (("dq",) if entry == "dq"
                                                             else ("dk", "dv"))),
                **{k: moe_sparse_row[f"{entry}_{k}"]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                "library_ms": moe_sparse_row["fwd_library_ms"] if entry == "fwd" else None},
            "ms": sp[f"{entry}_ms"], "plain_ms": sp[f"{entry}_plain_ms"],
            "bound_ms": sp[f"{entry}_bound_ms"], "bound_by": sp[f"{entry}_bound_by"],
            # SDPA under the layout's token mask computes the forward; no
            # single call computes dq or dk/dv alone (its backward is in the
            # kernel phase line)
            "library_ms": sp["fwd_library_ms"] if entry == "fwd" else None})
    # the forward's instances on the SD-1.5 path, each timed at its largest
    # shape there, with its launches in the served request
    k1a, k1b = (f"deepspeed_tpu/ops/pallas/flash_attention.py:{n}" for n in (123, 153))
    sd_instances = (("causal, head dim 64 (CLIP)", "sd_clip_d64", 64, k1a),
                    ("head dim 40 (UNet 64 x 64)", "sd_unet_self_d40", 40, k1b),
                    ("head dim 80 (UNet 32 x 32)", "sd_unet_self_d80", 80, k1b),
                    ("head dim 160 (UNet 16 x 16, 8 x 8)", "sd_unet_self_d160", 160, k1b),
                    ("head dim 512 (VAE mid attention)", "sd_vae_decode_d512", 512, k1b))
    kernels += [{"name": f"flash_attention_fwd [sd1.5 {label}]", "route": "cuda",
                 "source": "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
                 "replaces": replaces,
                 "launches": sum(n for (dim, *_), n in sd_calls.items() if dim == d),
                 **{k: sd_fwd[row][k] for k in keys},
                 "library_backend": sd_fwd[row]["library_backend"],
                 "at_sd_shapes": {name: {k: r[k] for k in (*keys, "library_backend")}
                                  for name, r in sd_fwd.items() if f"_d{d}" in name}}
                for label, row, d, replaces in sd_instances]
    # the head dim 256 instances on GPT-J-6B's served path, at its shapes
    gptj = variant_launches["serve_gpt-j-6b"]
    kernels += [
        {"name": "flash_attention_fwd [gpt-j-6b head dim 256]", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu", "replaces": k1a,
         "launches": gptj["flash_attention_fwd"], **{k: gptj_fwd["gptj_d256"][k] for k in keys},
         "library_backend": gptj_fwd["gptj_d256"]["library_backend"],
         "at_d256_shapes": {name: {k: r[k] for k in (*keys, "library_backend")}
                            for name, r in gptj_fwd.items()}},
        {"name": "decode_attention [gpt-j-6b head dim 256]", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
         "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:47",
         "launches": gptj["decode_attention"], **{k: gptj_decode["gptj_d256"][k] for k in keys},
         "at_d256_shapes": {name: {k: r[k] for k in keys} for name, r in gptj_decode.items()}}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
