"""The switches a one-card run reaches, in the port against the JAX package,
on the CPU: the config surface and the small runtime pieces.

The ds_config parses the ``activation_checkpointing`` block with the JAX
fields and defaults, and ``memory_breakdown``, ``dump_state`` and random-
LTD's ``data_efficiency.data_routing`` as JAX does. The JAX advisory keys
(its ``ADVISORY_NOOP_KEYS``) are exactly the port's accepted and refused
ones: each accepted key starts an engine and is logged with a reason that
cites the port's code by file, and each refused one starts an engine at
the value that asks for nothing and raises ``ValueError`` naming the knob
at another. The keys of later slices still raise. ``dump_state`` prints
the config and ``memory_breakdown`` reports memory on the printed steps.
``constant_schedule``, ``ThroughputTimer``'s epoch count and TFLOP/s,
``see_memory_usage``, ``partition_uniform`` / ``partition_balanced``,
``get_global_norm`` and ``DummyOptim`` match the JAX ones; random-LTD's
scheduler gives the JAX values over a ramp, and its gather and scatter the
JAX results bit for bit on the same indices. BERT accepts ``flash_block``.
"""

import logging
import os
import re

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime import utils as tutils
from deepspeed_tpu_torch.runtime.data_pipeline import data_routing as troute
from deepspeed_tpu_torch.utils.logging import logger as tlogger

BASE = {"train_batch_size": 4, "steps_per_print": 1,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
SMALL = dict(vocab_size=128, n_positions=16, n_embd=32, n_layer=2, n_head=2, remat=False,
             dtype=torch.float32)


@pytest.fixture
def port_log():
    """The port logger's lines (it does not propagate to the root logger)."""
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Keep()
    tlogger.addHandler(handler)
    yield lines
    tlogger.removeHandler(handler)


def _engine(**extra):
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL)).init_params(
        torch.Generator().manual_seed(0))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config={**BASE, **extra},
                                                device="cpu")
    return engine


def _batch():
    return {"input_ids": torch.from_numpy(
        np.random.RandomState(0).randint(0, 128, size=(4, 16)).astype(np.int64))}


# ------------------------------------------------------------- the config
def test_activation_checkpointing_block_parses_like_jax():
    block = {"partition_activations": True, "cpu_checkpointing": True,
             "contiguous_memory_optimization": False, "number_checkpoints": 4,
             "synchronize_checkpoint_boundary": True, "profile": True}
    for cfg in ({}, {"activation_checkpointing": block}):
        j = jconfig.DeepSpeedConfig({"train_batch_size": 4, **cfg})
        t = tconfig.DeepSpeedConfig({"train_batch_size": 4, **cfg})
        for f in block:
            assert getattr(t.activation_checkpointing_config, f) == \
                getattr(j.activation_checkpointing_config, f), f
    with pytest.raises(ValueError, match="did you mean 'cpu_checkpointing'"):
        tconfig.DeepSpeedConfig({"train_batch_size": 4,
                                 "activation_checkpointing": {"cpu_checkpoint": True}})


@pytest.mark.parametrize("flags", [{}, {"memory_breakdown": True},
                                   {"dump_state": True, "memory_breakdown": False}])
def test_memory_breakdown_and_dump_state_parse_like_jax(flags):
    j = jconfig.DeepSpeedConfig({"train_batch_size": 4, **flags})
    t = tconfig.DeepSpeedConfig({"train_batch_size": 4, **flags})
    assert (t.memory_breakdown, t.dump_state) == (j.memory_breakdown, j.dump_state)


def test_advisory_keys_are_the_jax_set():
    port = set(tconfig.ADVISORY_NOOP_KEYS) | set(tconfig.ADVISORY_REFUSED_KEYS)
    assert port == set(jconfig.ADVISORY_NOOP_KEYS)
    assert not set(tconfig.ADVISORY_NOOP_KEYS) & set(tconfig.ADVISORY_REFUSED_KEYS)
    assert not port & tconfig.LATER_KEYS
    for key in ("activation_checkpointing", "memory_breakdown", "dump_state",
                "hybrid_engine", "compression_training", "eigenvalue"):
        assert key in tconfig.SUPPORTED_KEYS and key not in tconfig.LATER_KEYS
    assert "gradient_compression" in tconfig.LATER_KEYS


def _cited_files(reason):
    return re.findall(r"((?:runtime|models|inference|utils|ops|parallel)/[\w/]+\.py)", reason)


@pytest.mark.parametrize("key", sorted(jconfig.ADVISORY_NOOP_KEYS))
def test_each_advisory_reason_cites_the_ports_code(key):
    reason = tconfig.DeepSpeedConfig({"train_batch_size": 4}).advisory_reason(key)
    cited = _cited_files(reason)
    assert cited, reason
    root = os.path.dirname(deepspeed_tpu_torch.__file__)
    for f in cited:
        assert os.path.exists(os.path.join(root, f)), f
    assert "XLA" not in reason and "TPU" not in reason
    # a cited line is within the function named after it (its def at most
    # ten lines before)
    for f, line, name in re.findall(r"([\w/]+\.py):(\d+)(?: (\w+))?", reason):
        lines = open(os.path.join(root, f)).read().splitlines()
        near = "\n".join(lines[max(0, int(line) - 10):int(line)])
        assert int(line) <= len(lines), (f, line)
        if "_" in name:
            assert name in near, (f, line, name)


ACCEPTED_VALUES = {"sparse_gradients": True, "prescale_gradients": True,
                   "nebula": {"enabled": True}, "zero_allow_untested_optimizer": True,
                   "zero_force_ds_cpu_optimizer": False, "timers": {"throughput": {}}}


@pytest.mark.parametrize("key", sorted(ACCEPTED_VALUES))
def test_accepted_advisory_keys_start_an_engine_and_are_logged(port_log, key):
    engine = _engine(**{key: ACCEPTED_VALUES[key]})
    assert engine._config.advisory_keys_set == [key]
    line = [m for m in port_log if f"config key {key!r} accepted" in m]
    assert line and tconfig.ADVISORY_NOOP_KEYS[key] in line[0]


REFUSED_VALUES = {"gradient_predivide_factor": (1.0, 2.0), "disable_allgather": (False, True),
                  "graph_harvesting": (False, True),
                  "use_data_before_expert_parallel": (False, True),
                  "communication_data_type": (None, "fp16")}


@pytest.mark.parametrize("key", sorted(REFUSED_VALUES))
def test_refused_advisory_keys_take_only_their_do_nothing_value(port_log, key):
    noop, other = REFUSED_VALUES[key]
    engine = _engine(**{key: noop})
    assert engine._config.advisory_keys_set == [key]
    assert any(f"config key {key!r} accepted" in m for m in port_log)
    # the JAX package accepts the other value silently; the port refuses it
    jconfig.DeepSpeedConfig({"train_batch_size": 4, key: other})
    with pytest.raises(ValueError, match=f"ds_config {key}=.*not supported on CUDA") as err:
        tconfig.DeepSpeedConfig({"train_batch_size": 4, key: other})
    assert _cited_files(str(err.value))


def test_communication_data_type_is_accepted_at_the_accumulation_type():
    ok = tconfig.DeepSpeedConfig({"train_batch_size": 4, "communication_data_type": "bf16",
                                  "data_types": {"grad_accum_dtype": "bf16"}})
    assert ok.grad_accum_dtype == torch.bfloat16
    tconfig.DeepSpeedConfig({"train_batch_size": 4, "communication_data_type": "fp32"})
    with pytest.raises(ValueError, match="grad_accum_dtype"):
        tconfig.DeepSpeedConfig({"train_batch_size": 4, "communication_data_type": "bf16"})


@pytest.mark.parametrize("later", ["gradient_compression", "gray", "autotuning",
                                   "perf", "pipeline", "analysis"])
def test_later_keys_still_raise(later):
    with pytest.raises(NotImplementedError, match=later):
        tconfig.DeepSpeedConfig({"train_batch_size": 4, later: {}})


def test_data_routing_block_is_accepted_as_in_jax():
    block = {"data_efficiency": {"enabled": True, "data_routing": {
        "enabled": True, "random_ltd": {"enabled": True, "total_layer_num": 2}}}}
    t = tconfig.DeepSpeedConfig({"train_batch_size": 4, **block})
    j = jconfig.DeepSpeedConfig({"train_batch_size": 4, **block})
    assert t.data_efficiency_config == j.data_efficiency_config
    engine = _engine(**block)
    assert np.isfinite(float(engine.train_batch(_batch())))


def test_dump_state_prints_the_config_and_memory_breakdown_reports(port_log):
    engine = _engine(dump_state=True, memory_breakdown=True)
    assert any('"dump_state": true' in m for m in port_log)
    engine.train_batch(_batch())
    report = [m for m in port_log if m.startswith("[Rank 0] after step 1")]
    assert report and "host:" in report[0]


# --------------------------------------------------------- the small gaps
def test_constant_schedule_matches_jax():
    from deepspeed_tpu.runtime.lr_schedules import constant_schedule as jconst

    from deepspeed_tpu_torch.runtime.lr_schedules import constant_schedule

    for lr in (1e-3, 0.1, 3.7e-5):
        for step in (0, 1, 1000):
            assert constant_schedule(lr)(step) == float(jconst(lr)(step))


def test_throughput_timer_epochs_and_tflops_match_jax():
    from deepspeed_tpu.utils.timer import ThroughputTimer as JTimer

    from deepspeed_tpu_torch.utils.timer import ThroughputTimer as TTimer

    lines = {"j": [], "t": []}
    j = JTimer(8, start_step=0, steps_per_output=2, logging_fn=lines["j"].append)
    t = TTimer(8, start_step=0, steps_per_output=2, logging_fn=lines["t"].append,
               synchronize=lambda: None)
    for timer in (j, t):
        timer.set_flops_per_batch(3e12)
        timer.update_epoch_count()
        for _ in range(4):
            timer.start()
            timer.stop(global_step=True)
        timer.update_epoch_count()
        assert (timer.epoch_count, timer.micro_step_count) == (2, 0)
    pattern = re.compile(r"epoch=1/micro_step=(\d)/global_step=(\d), .*, EstTFLOPs=[\d.]+$")
    assert [pattern.match(m).groups() for m in lines["t"]] == \
        [pattern.match(m).groups() for m in lines["j"]] == [("2", "2"), ("4", "4")]
    assert t.flops_per_batch == j.flops_per_batch == 3e12


def test_runtime_utils_match_jax(port_log):
    from deepspeed_tpu.runtime import utils as jutils

    for items, parts in ((10, 3), (7, 7), (5, 2), (100, 8)):
        assert tutils.partition_uniform(items, parts) == jutils.partition_uniform(items, parts)
    rs = np.random.RandomState(0)
    for n, parts in ((12, 4), (5, 2), (9, 3)):
        w = rs.rand(n).tolist()
        assert tutils.partition_balanced(w, parts) == jutils.partition_balanced(w, parts)
    norms = rs.rand(6).tolist()
    assert tutils.get_global_norm(norms) == pytest.approx(jutils.get_global_norm(norms),
                                                          rel=1e-12)
    tutils.see_memory_usage("not forced")
    tutils.memory_status("forced", reset_max=True)
    tutils.empty_cache()
    assert not any("not forced" in m for m in port_log)
    assert any(m.startswith("[Rank 0] forced") and "host:" in m for m in port_log)


def test_dummy_optim_trains_nothing():
    client = tutils.DummyOptim()
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL)).init_params(
        torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, optimizer=client,
                                                config={"train_batch_size": 4}, device="cpu")
    engine.train_batch(_batch())
    assert engine.opt_state.count == 1
    assert all(torch.equal(p.detach(), before[n]) for n, p in model.named_parameters())


def test_bert_accepts_flash_block():
    from deepspeed_tpu_torch.models import bert as tbert

    cfg = tbert.BertConfig(**{**dict(tbert.PRESETS["bert-tiny"].__dict__),
                              "flash_block": 64, "dtype": torch.float32})
    assert cfg.flash_block == 64
    model = tbert.BertModel(cfg).init_params(torch.Generator().manual_seed(0))
    ref = tbert.BertModel(tbert.BertConfig(**{**cfg.__dict__, "flash_block": None}))
    ref.load_state_dict(model.state_dict(), assign=True)
    ids = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(model.apply(ids), ref.apply(ids))


# ------------------------------------------------------------- random-LTD
LTD = {"total_layer_num": 12, "random_ltd_layer_num": 10, "global_batch_size": 16,
       "schedule": {"min_value": 128, "max_value": 1024, "schedule_type": "fixed_linear",
                    "schedule_config": {"require_steps": 200, "seq_per_step": 16}}}


def test_random_ltd_scheduler_matches_jax():
    from deepspeed_tpu.runtime.data_pipeline import RandomLTDScheduler as JSched

    from deepspeed_tpu_torch.runtime.data_pipeline import RandomLTDScheduler as TSched

    j, t = JSched(LTD), TSched(LTD)
    for step in list(range(0, 260, 7)) + [260, 260, 300]:
        assert t.update_seq(step) == j.update_seq(step), step
        assert t.consumed_layer_tokens == j.consumed_layer_tokens
        assert t.get_value(step) == j.get_value(step)
    assert t.state_dict() == j.state_dict()
    fresh = TSched(LTD)
    fresh.load_state_dict(t.state_dict())
    assert fresh.state_dict() == t.state_dict()
    assert TSched(LTD).get_total_layer_tokens(50) == JSched(LTD).get_total_layer_tokens(50)
    with pytest.raises(RuntimeError, match="Unsupported"):
        TSched({**LTD, "schedule": {**LTD["schedule"], "schedule_type": "cosine"}}).get_value(1)


def test_random_ltd_gather_scatter_match_jax_bit_for_bit():
    import jax.numpy as jnp

    from deepspeed_tpu.runtime.data_pipeline import data_routing as jroute

    rs = np.random.RandomState(3)
    B, T, D, kept = 3, 24, 8, 10
    x = rs.standard_normal((B, T, D)).astype(np.float32)
    idx = np.sort(np.stack([rs.permutation(T)[:kept] for _ in range(B)]), axis=1)
    small = rs.standard_normal((B, kept, D)).astype(np.float32)
    g = troute.random_ltd_gather(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jroute.random_ltd_gather(
        jnp.asarray(x), jnp.asarray(idx))))
    full = torch.from_numpy(x)
    s = troute.random_ltd_scatter(torch.from_numpy(small), torch.from_numpy(idx), full)
    np.testing.assert_array_equal(s.numpy(), np.asarray(jroute.random_ltd_scatter(
        jnp.asarray(small), jnp.asarray(idx), jnp.asarray(x))))
    assert torch.equal(full, torch.from_numpy(x))           # the input is not modified


def test_random_ltd_sample_is_sorted_distinct_and_seeded():
    a = troute.random_ltd_sample(torch.Generator().manual_seed(0), 32, 12, 4)
    b = troute.random_ltd_sample(torch.Generator().manual_seed(0), 32, 12, 4)
    assert a.shape == (4, 12) and a.dtype == torch.long and torch.equal(a, b)
    assert (a[:, 1:] > a[:, :-1]).all() and a.min() >= 0 and a.max() < 32
    assert not torch.equal(a, troute.random_ltd_sample(torch.Generator().manual_seed(1),
                                                       32, 12, 4))
