"""The port's flops profiler against the JAX package's jaxpr count, on the CPU.

The unit cases of ``tests/unit/test_profiling.py`` (a matmul, a batched
einsum, a scanned loop of four matmuls, a checkpointed matmul counted once
in the forward) and a convolution and a matmul's gradient, each in torch
and in JAX: :class:`FlopCounter`'s count equals ``count_jaxpr_flops`` as an
integer. A whole ``train_batch`` of gpt2-tiny and of llama-tiny (grouped KV
heads), remat off and on, counted by the engine's ``flops_profiler`` at
``profile_step``, equals ``count_jaxpr_flops`` of the JAX engine's train
step for the same config, shapes and weights (the JAX models take the
einsum attention off the TPU; the port's attention reports the einsum
formula whichever body runs). The attention ops count that formula and
not their plain versions' products. ``get_model_profile`` returns JAX's
(flops, MACs, params). The engine prints the profile at ``profile_step``,
gives EstTFLOPs and ``train/flops_per_batch`` the count, and a profiled
step's losses and state equal an unprofiled run's bit for bit; without the
block the profiler is never imported; the NVMe optimizer's host-side step
is skipped with a warning, as in JAX.
"""

import dataclasses
import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.profiling.flops_profiler.profiler import count_jaxpr_flops
from deepspeed_tpu.profiling.flops_profiler.profiler import get_model_profile as jprofile
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.ops.pallas import flash_attention as tfa
from deepspeed_tpu_torch.profiling.flops_profiler import (FlopCounter, FlopsProfiler,
                                                          get_model_profile)

CONFIG = {"train_batch_size": 8, "steps_per_print": 0,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}


def _torch_count(fn, *args, model=None):
    counter = FlopCounter(model)
    with counter.scoped(), counter:
        fn(*args)
    return counter.total


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _loop(x, ws):
    for w in ws:
        x = x @ w
    return x


def _scan(x, ws):
    return jax.lax.scan(lambda c, w: (c @ w, ()), x, ws)[0]


def _conv_jax(x, w, stride):
    return jax.lax.conv_general_dilated(x, w, (stride, stride), "SAME",
                                        dimension_numbers=("NCHW", "OIHW", "NCHW"))


def _grad_case(tfn, jfn, *arrays):
    """(torch count of the forward and backward of sum(tfn), JAX count of
    grad of sum(jfn)) w.r.t. every input."""
    ts = [_t(a, grad=True) for a in arrays]
    got = _torch_count(lambda: tfn(*ts).sum().backward())
    want, _ = count_jaxpr_flops(jax.grad(lambda *a: jfn(*a).sum(), argnums=tuple(
        range(len(arrays)))), *[jnp.asarray(a) for a in arrays])
    return got, want


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


UNIT_CASES = {
    "matmul": lambda: (_torch_count(lambda a, b: a @ b, _t(_rand(8, 16)), _t(_rand(16, 32))),
                       count_jaxpr_flops(lambda a, b: a @ b, jnp.zeros((8, 16)),
                                         jnp.zeros((16, 32)))[0], 2 * 8 * 16 * 32),
    "batched": lambda: (
        _torch_count(lambda a, b: torch.einsum("bmk,bkn->bmn", a, b), _t(_rand(4, 8, 16)),
                     _t(_rand(4, 16, 32))),
        count_jaxpr_flops(lambda a, b: jnp.einsum("bmk,bkn->bmn", a, b),
                          jnp.zeros((4, 8, 16)), jnp.zeros((4, 16, 32)))[0], 2 * 4 * 8 * 16 * 32),
    "loop_of_4": lambda: (_torch_count(_loop, _t(_rand(16, 16)), _t(_rand(4, 16, 16))),
                          count_jaxpr_flops(_scan, jnp.zeros((16, 16)),
                                            jnp.zeros((4, 16, 16)))[0], 4 * 2 * 16 ** 3),
    "checkpoint_forward_once": lambda: (
        _torch_count(lambda x, w: torch.utils.checkpoint.checkpoint(
            torch.matmul, x, w, use_reentrant=False), _t(_rand(8, 8)), _t(_rand(8, 8))),
        count_jaxpr_flops(jax.checkpoint(lambda x, w: x @ w), jnp.zeros((8, 8)),
                          jnp.zeros((8, 8)))[0], 2 * 8 ** 3),
    "conv_stride1": lambda: (
        _torch_count(lambda x, w: torch.nn.functional.conv2d(x, w, padding="same"),
                     _t(_rand(2, 3, 8, 8)), _t(_rand(5, 3, 3, 3))),
        count_jaxpr_flops(lambda x, w: _conv_jax(x, w, 1), jnp.zeros((2, 3, 8, 8)),
                          jnp.zeros((5, 3, 3, 3)))[0], 2 * (2 * 5 * 8 * 8) * 3 * 9),
    "linear_grad": lambda: (*_grad_case(lambda x, w: x @ w, lambda x, w: x @ w,
                                        _rand(8, 16), _rand(16, 4)), 3 * 2 * 8 * 16 * 4),
    "conv_grad": lambda: (*_grad_case(
        lambda x, w: torch.nn.functional.conv2d(x, w, padding=1),
        lambda x, w: _conv_jax(x, w, 1), _rand(2, 3, 8, 8), _rand(5, 3, 3, 3)),
        3 * 2 * (2 * 5 * 8 * 8) * 3 * 9),
}


@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_unit_counts_equal_jax(case):
    got, want, closed = UNIT_CASES[case]()
    assert got == want == closed


def test_attention_reports_the_einsum_formula_not_its_plain_products():
    """Causal flash attention, its backward, and the block-sparse pair each
    count 4·BH·T²·D forward and 8·BH·T²·D backward (the einsum path's full
    square, as ``mha_reference`` itself counts), whatever body runs."""
    B, T, H, D = 2, 32, 2, 16
    q, k, v = (_t(_rand(B, T, H, D, seed=s), grad=True) for s in range(3))
    einsum = 12 * B * H * T * T * D
    for fn in (lambda: tfa.flash_attention(q, k, v, causal=True),
               lambda: tfa.mha_reference(q, k, v, causal=True),
               lambda: tfa.flash_attention_sparse(q, k, v, np.tril(np.ones((2, 2))), True)):
        assert _torch_count(lambda: fn().float().sum().backward()) == einsum
    with torch.no_grad():
        assert _torch_count(lambda: tfa.flash_attention(q, k, v)) == einsum // 3
    assert tfa.einsum_attention_flops(B * H, T, T, D, backward=True) == 2 * einsum // 3


def _jax_params(state_dict):
    """A port state dict as the JAX params tree (blocks stacked over layers)."""
    tree = {}
    for name, t in state_dict.items():
        a = jnp.asarray(t.detach().float().numpy())
        if name.startswith("blocks."):
            _, n, key = name.split(".")
            tree.setdefault("blocks", {}).setdefault(key, {})[int(n)] = a
        else:
            tree[name] = a
    tree["blocks"] = {k: jnp.stack([v[n] for n in sorted(v)])
                      for k, v in tree["blocks"].items()}
    return tree


FAMILIES = {
    "gpt2": (tgpt2, jgpt2, "gpt2-tiny", tgpt2.GPT2Model, jgpt2.GPT2Model),
    "llama": (tllama, jllama, "llama-tiny", tllama.LlamaModel, jllama.LlamaModel),
}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_batch_count_equals_jax(family, remat):
    tmod, jmod, preset, TModel, JModel = FAMILIES[family]
    c = tmod.PRESETS[preset]
    ids = np.random.RandomState(0).randint(0, c.vocab_size, size=(8, 32))
    config = {**CONFIG, "flops_profiler": {"enabled": True, "profile_step": 1}}
    tcfg = dataclasses.replace(c, dtype=torch.float32, remat=remat)
    engine, *_ = deepspeed_tpu_torch.initialize(model=TModel(tcfg), config=config,
                                                device="cpu")
    params = _jax_params(engine.module_state_dict())
    engine.train_batch({"input_ids": torch.tensor(ids)})
    got = engine.flops_profile

    jcfg = dataclasses.replace(jmod.PRESETS[preset], dtype=jnp.float32, remat=remat)
    jeng, *_ = deepspeed_tpu.initialize(model=JModel(jcfg), model_parameters=params,
                                        config=dict(CONFIG))
    shapes = {"input_ids": jax.ShapeDtypeStruct(ids.shape, jnp.int32)}
    with jeng.mesh:
        want, _ = count_jaxpr_flops(jeng._build_train_batch_fn(1), jeng.state, shapes)
    assert int(got.flops) == want
    assert got.macs == want // 2 and got.params == sum(p.numel() for p in
                                                       engine.module.parameters())
    # every block's share is the same, and the trunk's blocks hold most of it
    blocks = [got.per_scope[f"blocks.{n}"] for n in range(c.n_layer)]
    assert len(set(blocks)) == 1 and sum(got.per_scope.values()) == want


def test_get_model_profile_returns_what_jax_returns(capsys):
    w = _rand(16, 16)
    want = jprofile(fn=lambda p, x: x @ p["w"], args=({"w": jnp.asarray(w)}, jnp.zeros((4, 16))),
                    params={"w": w}, print_profile=False, as_string=False)
    got = get_model_profile(fn=lambda p, x: x @ p["w"], args=({"w": _t(w)}, torch.zeros(4, 16)),
                            params={"w": _t(w)}, print_profile=False, as_string=False)
    assert got == (float(2 * 4 * 16 * 16), 4 * 16 * 16, 256)
    assert got == (float(want[0]), want[1], want[2])
    assert get_model_profile(fn=lambda p, x: x @ p["w"], args=({"w": _t(w)},
                                                               torch.zeros(4, 16)),
                             params={"w": _t(w)}, print_profile=False) == \
        jprofile(fn=lambda p, x: x @ p["w"], args=({"w": jnp.asarray(w)}, jnp.zeros((4, 16))),
                 params={"w": w}, print_profile=False)
    # a model's apply is the default forward
    model = tgpt2.GPT2Model(dataclasses.replace(tgpt2.PRESETS["gpt2-tiny"], dtype=torch.float32))
    model.init_params(torch.Generator().manual_seed(0))
    flops, macs, n = get_model_profile(model, args=(torch.zeros(2, 8, dtype=torch.long),),
                                       params=model, print_profile=True, as_string=False)
    assert n == sum(p.numel() for p in model.parameters()) and flops == 2 * macs > 0
    out = capsys.readouterr().out
    assert "Flops Profiler" in out and "MACs" in out and "2 x MACs" in out


class _Log(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_engine_prints_the_profile_and_sets_est_tflops(capsys, tmp_path):
    from deepspeed_tpu_torch.utils.logging import logger

    log = _Log()
    logger.addHandler(log)
    c = dataclasses.replace(tgpt2.PRESETS["gpt2-tiny"], dtype=torch.float32, remat=False)
    config = {**CONFIG, "steps_per_print": 3,
              "flops_profiler": {"enabled": True, "profile_step": 2, "top_modules": 3},
              "telemetry": {"enabled": True, "output_dir": str(tmp_path), "flush_interval": 100}}
    try:
        engine, *_ = deepspeed_tpu_torch.initialize(model=tgpt2.GPT2Model(c), config=config,
                                                    device="cpu")
        batch = tgpt2.synthetic_lm_batch(8, 32, c.vocab_size)
        engine.train_batch(batch)
        assert engine.flops_profile is None and engine.tput_timer.flops_per_batch is None
        engine.train_batch(batch)
        flops = engine.flops_profile.flops
        out = capsys.readouterr().out
        assert "Flops Profiler" in out and "Profile step:                   2" in out
        assert "blocks.1" in out and "Step latency" in out
        assert engine.tput_timer.flops_per_batch == flops > 0
        reg = {r["name"]: r for r in ttel.get_registry().snapshot()}
        assert reg["train/flops_per_batch"]["value"] == flops
        engine.train_batch(batch)
        assert any("EstTFLOPs=" in m for m in log.messages), log.messages
    finally:
        logger.removeHandler(log)
        ttel.deconfigure()


def test_a_profiled_step_changes_no_bit():
    """Losses and the whole state after 3 steps with a profile at step 2
    equal an unprofiled run's bit for bit (dropout on: the generators too)."""
    c = dataclasses.replace(tgpt2.PRESETS["gpt2-tiny"], dtype=torch.float32, dropout=0.1)
    batch = tgpt2.synthetic_lm_batch(8, 32, c.vocab_size)
    runs = []
    for block in ({}, {"flops_profiler": {"enabled": True, "profile_step": 2}}):
        engine, *_ = deepspeed_tpu_torch.initialize(model=tgpt2.GPT2Model(c),
                                                    config={**CONFIG, **block}, device="cpu")
        losses = [float(engine.train_batch(batch)) for _ in range(3)]
        runs.append((losses, engine.module_state_dict(), engine.opt_state))
    assert runs[1][0] == runs[0][0]
    assert all(torch.equal(runs[1][1][k], runs[0][1][k]) for k in runs[0][1])
    assert all(torch.equal(a, b) for a, b in zip(runs[1][2].mu + runs[1][2].nu,
                                                 runs[0][2].mu + runs[0][2].nu))


def test_without_the_block_the_profiler_is_not_imported():
    mod = "deepspeed_tpu_torch.profiling.flops_profiler.profiler"
    pkg = "deepspeed_tpu_torch.profiling.flops_profiler"
    saved = {m: sys.modules.pop(m) for m in (mod, pkg) if m in sys.modules}
    try:
        c = dataclasses.replace(tgpt2.PRESETS["gpt2-tiny"], dtype=torch.float32)
        for block in ({}, {"flops_profiler": {"enabled": False, "profile_step": 1}}):
            engine, *_ = deepspeed_tpu_torch.initialize(model=tgpt2.GPT2Model(c),
                                                        config={**CONFIG, **block},
                                                        device="cpu")
            engine.train_batch(tgpt2.synthetic_lm_batch(8, 16, c.vocab_size))
            assert engine.flops_profile is None and engine.tput_timer.flops_per_batch is None
            assert mod not in sys.modules and pkg not in sys.modules
    finally:
        sys.modules.update(saved)


def test_profiler_start_stop_accessors():
    prof = FlopsProfiler()
    prof.start_profile()
    _t(_rand(4, 8)) @ _t(_rand(8, 2))
    prof.stop_profile()
    assert prof.get_total_macs() == 64 and prof.get_total_flops() == 128.0
    assert prof.get_total_flops(as_string=True) == "128.00 FLOPS"
    assert prof.per_scope == {"": 128}
    prof.end_profile()
    assert prof.get_total_flops() == 0.0 and not prof.started


def test_the_nvme_optimizer_path_warns_and_skips(tmp_path):
    """The NVMe optimizer steps on the host: the profiler warns at
    ``profile_step`` and counts nothing, as the JAX engine skips it."""
    from deepspeed_tpu_torch.utils.logging import logger

    log = _Log()
    logger.addHandler(log)
    c = dataclasses.replace(tgpt2.PRESETS["gpt2-tiny"], dtype=torch.float32, remat=False)
    config = {**CONFIG, "flops_profiler": {"enabled": True, "profile_step": 1},
              "zero_optimization": {"stage": 1, "offload_optimizer": {
                  "device": "nvme", "nvme_path": str(tmp_path)}}}
    try:
        engine, *_ = deepspeed_tpu_torch.initialize(model=tgpt2.GPT2Model(c), config=config,
                                                    device="cpu")
        engine.train_batch(tgpt2.synthetic_lm_batch(8, 16, c.vocab_size))
    finally:
        logger.removeHandler(log)
    assert engine.flops_profile is None and engine.tput_timer.flops_per_batch is None
    assert any("NVMe-offload optimizer" in m for m in log.messages), log.messages
