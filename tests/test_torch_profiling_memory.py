"""The port's memory profiler, memory summary and scaling arithmetic
against the JAX package's, on the CPU.

The census attributes storages to buckets as JAX's attributes arrays (the
same shapes give the same ``CensusResult``; a storage shared by views
counts once; the first bucket claiming one wins). An engine's ``params``
and ``master`` buckets hold JAX's bytes for the same gpt2-tiny bf16 config,
and ``optimizer_state`` JAX's less its Adam step count (an int32 leaf in
JAX, a host integer in the port); ``state_misc`` differs by design (JAX's
step, RNG key and skip count are device arrays, the port's are host
integers) and so does ``grad_buffer`` (the port's flat gradient buffers
live only inside a step). ``SpanMemoryTracer`` and the leak sentinel, given
the same scripted statistics, give JAX's histograms, counters and warning;
``render_memory_summary`` renders the same records to the same text;
``solve_breakdown`` and ``project_northstar`` give JAX's results. The
engine samples at step 1 and every ``sample_interval`` steps, and without
the ``profiling`` block it imports no profiler and takes no census.
"""

import logging
import math
import sys

import jax.numpy as jnp
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.profiling import memory as jmem
from deepspeed_tpu.profiling import report as jreport
from deepspeed_tpu.profiling import scaling as jscaling
from deepspeed_tpu.runtime.config import TelemetryConfig as JTelemetryConfig
from deepspeed_tpu.telemetry.tracing import StepTracer as JTracer
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.profiling import memory as tmem
from deepspeed_tpu_torch.profiling import report as treport
from deepspeed_tpu_torch.profiling import scaling as tscaling
from deepspeed_tpu_torch.runtime.config import TelemetryConfig as TTelemetryConfig
from deepspeed_tpu_torch.telemetry.tracing import StepTracer as TTracer

SIDES = {"jax": (jtel, JTelemetryConfig, JTracer, jmem), "torch": (ttel, TTelemetryConfig,
                                                                    TTracer, tmem)}
BF16 = {"train_batch_size": 8, "steps_per_print": 0,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-4}}, "bf16": {"enabled": True}}


@pytest.fixture(autouse=True)
def _no_sessions():
    yield
    jtel.deconfigure()
    ttel.deconfigure()


def _session(side, tmp_path):
    tel, Cfg, _, _ = SIDES[side]
    s = tel.TelemetrySession(Cfg(enabled=True, output_dir=str(tmp_path / side),
                                 flush_interval=10_000))
    tel.install_session(s)
    return s


class _Log(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def logs():
    from deepspeed_tpu.utils.logging import logger as jlog
    from deepspeed_tpu_torch.utils.logging import logger as tlog

    handlers = {"jax": _Log(), "torch": _Log()}
    jlog.addHandler(handlers["jax"])
    tlog.addHandler(handlers["torch"])
    yield handlers
    jlog.removeHandler(handlers["jax"])
    tlog.removeHandler(handlers["torch"])


# --------------------------------------------------------------- the census
def test_synthetic_census_equals_jax():
    shapes = {"a": (16,), "b": (8, 8), "c": (4,)}
    j = {k: jnp.ones(v, jnp.float32) for k, v in shapes.items()}
    t = {k: torch.ones(v) for k, v in shapes.items()}
    for named in (lambda x: {"params": {"w": x["a"]}, "optimizer_state": [x["b"]]},
                  lambda x: {"params": x["a"], "master": x["a"]}):
        want = jmem.census(named(j), live=list(j.values()))
        got = tmem.census(named(t), live=list(t.values()))
        assert got == want
        assert got.fraction_attributed == want.fraction_attributed
    # a storage shared by views counts once, for its first bucket
    flat = torch.zeros(24)
    views = [flat[:16], flat[16:]]
    res = tmem.census({"params": views, "master": [flat]}, live=[*views, flat, t["c"]])
    assert res.bucket_bytes == {"params": 96, "master": 0, "other": 16}
    assert res.bucket_counts == {"params": 1, "master": 0, "other": 1}
    assert (res.total_bytes, res.attributed_bytes, res.other_bytes) == (112, 96, 16)


def test_engine_census_buckets_equal_jax():
    jeng, *_ = deepspeed_tpu.initialize(model=jgpt2.GPT2Model(jgpt2.PRESETS["gpt2-tiny"]),
                                        config=dict(BF16))
    want = jeng.memory_census().bucket_bytes
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.GPT2Model(tgpt2.PRESETS["gpt2-tiny"]), config=dict(BF16), device="cpu")
    teng.train_batch(tgpt2.synthetic_lm_batch(8, 32, tgpt2.PRESETS["gpt2-tiny"].vocab_size))
    got = teng.memory_census().bucket_bytes
    n = sum(p.numel() for p in teng.module.parameters())
    assert got["params"] == want["params"] == 2 * n
    assert got["master"] == want["master"] == 4 * n
    # JAX's Adam state holds its step count as an int32 leaf
    assert got["optimizer_state"] == want["optimizer_state"] - 4 == 8 * n
    assert got["state_misc"] == 0 and "grad_buffer" not in got


# ------------------------------------------------------- span peaks, leaks
SPAN_FEED = [{"bytes_in_use": 100},                            # before 1
             {"bytes_in_use": 200, "peak_bytes_in_use": 350},  # after 1
             {"bytes_in_use": 500},                            # before 2
             {"bytes_in_use": 40, "peak_bytes_in_use": 40}]    # after 2


def test_span_memory_tracer_equals_jax(tmp_path):
    out = {}
    for side in SIDES:
        tel, _, Tracer, mem = SIDES[side]
        _session(side, tmp_path)
        feed = list(SPAN_FEED)
        smt = mem.SpanMemoryTracer(Tracer(), stats_fn=lambda: feed.pop(0))
        for step in (1, 2):
            with smt.span("fwd", step=step):
                pass
        probes = []
        dead = mem.SpanMemoryTracer(Tracer(), stats_fn=lambda: probes.append(1) or None)
        for _ in range(3):
            with dead.span("bwd"):
                pass
        out[side] = ([r for r in tel.get_registry().snapshot()
                      if r["name"] == "profiling/span_peak_bytes"],
                     [e["name"] for e in smt.events], len(probes))
        tel.deconfigure()
    assert out["torch"] == out["jax"]
    [rec] = out["torch"][0]
    assert rec["labels"] == {"span": "fwd"} and rec["count"] == 2
    assert (rec["max"], rec["min"]) == (250, 0) and out["torch"][2] == 1


def _result(mem, other):
    buckets = {"params": 1000, "other": other}
    return mem.CensusResult(bucket_bytes=buckets, bucket_counts={b: 1 for b in buckets},
                            total_bytes=sum(buckets.values()), attributed_bytes=1000)


@pytest.mark.parametrize("window,floor,others", [
    (3, 100, [0, 100, 250, 400]),          # monotonic growth past the floor: flagged
    (3, 10_000, [0, 100, 250, 400]),       # under the floor: quiet
    (3, 0, [0, 500, 300, 600]),            # not monotonic: quiet
    (2, 0, [0, 10, 20, 30, 40])])          # flagged twice, warned once
def test_leak_sentinel_equals_jax(tmp_path, logs, window, floor, others):
    out = {}
    for side in SIDES:
        tel, _, _, mem = SIDES[side]
        _session(side, tmp_path)
        prof = mem.MemoryProfiler(leak_window=window, leak_min_growth_bytes=floor)
        for i, n in enumerate(others):
            prof._observe_leak(i + 1, _result(mem, n))
        out[side] = ([r for r in tel.get_registry().snapshot()
                      if r["name"] == "profiling/leak_suspects"],
                     [m for m in logs[side].messages if "leak sentinel" in m])
        tel.deconfigure()
    assert out["torch"] == out["jax"]
    if floor == 100:
        [rec] = out["torch"][0]
        assert rec["labels"] == {"bucket": "other"} and rec["value"] == 1
        assert "top-growing bucket: 'other'" in out["torch"][1][0]


# ---------------------------------------------------------- memory summary
RECORDS = [
    {"kind": "gauge", "name": "profiling/live_bytes", "labels": {"bucket": "params"},
     "value": 1.5e9},
    {"kind": "gauge", "name": "profiling/live_bytes", "labels": {"bucket": "other"},
     "value": 2.5e8},
    {"kind": "gauge", "name": "profiling/live_bytes", "labels": {"bucket": "master"},
     "value": 3e9},
    {"kind": "gauge", "name": "profiling/live_bytes_total", "labels": {}, "value": 4.75e9},
    {"kind": "gauge", "name": "profiling/attributed_fraction", "labels": {},
     "value": 0.947},
    {"kind": "histogram", "name": "profiling/span_peak_bytes", "labels": {"span": "fwd"},
     "max": 123456789, "p50": 1000, "count": 7},
    {"kind": "histogram", "name": "profiling/span_peak_bytes",
     "labels": {"span": "train_batch"}, "max": 9e9, "p50": 8e9, "count": 3},
    {"kind": "gauge", "name": "profiling/executable_temp_bytes", "labels": {},
     "value": 2048},
    {"kind": "gauge", "name": "device/bytes_in_use", "labels": {}, "value": 512},
    {"kind": "counter", "name": "profiling/leak_suspects", "labels": {"bucket": "other"},
     "value": 2},
    {"kind": "gauge", "name": "train/loss", "labels": {}, "value": 3.0},
]


@pytest.mark.parametrize("records,source", [(RECORDS, None), (RECORDS, "run/metrics.jsonl"),
                                            (RECORDS[:5], None), (RECORDS[-1:], "x"),
                                            ([], None)])
def test_memory_summary_text_equals_jax(records, source):
    assert treport.render_memory_summary(records, source) == \
        jreport.render_memory_summary(records, source)


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 5 * 2 ** 20, 3.5 * 2 ** 30, 7 * 2 ** 40,
                               2 ** 60, -2048])
def test_formatters_equal_jax(n):
    assert treport.format_bytes(n) == jreport.format_bytes(n)
    assert treport.format_us(abs(n) / 1e3) == jreport.format_us(abs(n) / 1e3)


# -------------------------------------------------------------- scaling math
@pytest.mark.parametrize("args", [(4 * 0.5 + 2.0, 4, 16 * 0.5 + 2.0, 16),
                                  (1.0, 1, 1.9, 2), (2.0, 4, 1.0, 16), (1.0, 2, 3.4, 4)])
def test_solve_breakdown_equals_jax(args):
    try:
        want = jscaling.solve_breakdown(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tscaling.solve_breakdown(*args)
        assert str(got.value) == str(e)
        return
    assert tscaling.solve_breakdown(*args) == want


@pytest.mark.parametrize("kw", [
    dict(n_params=1_557_000_000, tokens_per_chip_step=8 * 1024 * 16, flops_per_token=9.3e9,
         measured_mfu_1chip=0.45, peak_flops=197e12, n_chips=64, ici_bytes_per_s=9e10),
    dict(n_params=758_700_000, tokens_per_chip_step=8192, flops_per_token=5e9,
         measured_mfu_1chip=0.17, peak_flops=989e12, n_chips=8, ici_bytes_per_s=4.5e11,
         overlap_mid=0.5, t_update_shard_s=0.004),
    dict(n_params=10, tokens_per_chip_step=1, flops_per_token=1.0, measured_mfu_1chip=1.2,
         peak_flops=1.0, ici_bytes_per_s=1.0)])
def test_project_northstar_equals_jax(kw):
    try:
        want = jscaling.project_northstar(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tscaling.project_northstar(**kw)
        assert str(got.value) == str(e)
        return
    got = tscaling.project_northstar(**kw)
    assert got == want
    assert got["projected_mfu_no_overlap"] <= got["projected_mfu_full_overlap"]
    assert math.isclose(tscaling.project_northstar(**{**kw, "ici_bytes_per_s":
                                                      tscaling.NVLINK_BYTES_PER_S})
                        ["assumed_ici_bytes_per_s"], 450e9)


# ----------------------------------------------------------- engine wiring
def _engine(tmp_path, profiling=None, telemetry=True):
    cfg = {"train_batch_size": 8, "steps_per_print": 0,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    if telemetry:
        cfg["telemetry"] = {"enabled": True, "output_dir": str(tmp_path / "telem"),
                            "flush_interval": 1}
    if profiling is not None:
        cfg["profiling"] = profiling
    c = tgpt2.GPT2Config(vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=4,
                         dtype=torch.float32)
    engine, *_ = deepspeed_tpu_torch.initialize(model=tgpt2.GPT2Model(c), config=cfg,
                                                device="cpu")
    return engine


def _batch(i=0):
    return tgpt2.synthetic_lm_batch(8, 16, 256, seed=i)


def test_engine_samples_the_census_into_gauges(tmp_path, logs):
    engine = _engine(tmp_path, profiling={"sample_interval": 1})
    for i in range(2):
        engine.train_batch(_batch(i))
    assert engine._mem_profiler.samples == 2
    by_name = {}
    for r in ttel.get_registry().snapshot():
        by_name.setdefault(r["name"], []).append(r)
    buckets = {r["labels"]["bucket"]: r["value"] for r in by_name["profiling/live_bytes"]}
    assert {"params", "master", "optimizer_state", "state_misc", "other"} <= set(buckets)
    n = sum(p.numel() for p in engine.module.parameters())
    assert buckets["params"] == buckets["master"] == 4 * n
    assert by_name["profiling/live_bytes_total"][0]["value"] >= 16 * n
    assert 0 < by_name["profiling/attributed_fraction"][0]["value"] <= 1
    # no executable analysis on CUDA: no gauges, and the reason said once
    assert not [k for k in by_name if k.startswith("profiling/executable_")]
    assert tmem.executable_memory(engine) is None
    assert len([m for m in logs["torch"].messages if "memory_analysis" in m]) == 1
    ttel.deconfigure()
    records, bad = treport.load_metrics_records(str(tmp_path / "telem" / "metrics.jsonl"))
    text = treport.render_memory_summary(records)
    assert bad == 0 and "live device bytes by bucket:" in text and "params" in text


@pytest.mark.parametrize("interval,steps,samples", [(3, 4, 2), (1, 3, 3), (10, 2, 1)])
def test_sample_interval_respected(tmp_path, interval, steps, samples):
    engine = _engine(tmp_path, profiling={"sample_interval": interval, "span_memory": False})
    for i in range(steps):
        engine.train_batch(_batch(i))
    assert engine._mem_profiler.samples == samples


def test_strict_noop_without_the_block(tmp_path):
    mod = "deepspeed_tpu_torch.profiling.memory"
    saved = {m: sys.modules.pop(m) for m in (mod,) if m in sys.modules}
    calls = tmem.CENSUS_CALLS
    try:
        for profiling in (None, {"enabled": False}):
            engine = _engine(tmp_path, profiling=profiling)
            engine.train_batch(_batch())
            assert engine._mem_profiler is None
            assert mod not in sys.modules
            assert not isinstance(ttel.get_session().tracer, tmem.SpanMemoryTracer)
        assert tmem.CENSUS_CALLS == calls
    finally:
        sys.modules.update(saved)


def test_span_memory_wraps_the_session_tracer(tmp_path):
    engine = _engine(tmp_path, profiling={})
    session = ttel.get_session()
    assert isinstance(session.tracer, tmem.SpanMemoryTracer)
    engine.train_batch(_batch())
    assert [e["name"] for e in session.tracer.events] == ["data", "train_batch"]
    # the CPU has no allocator statistics: probed once, no histogram
    assert not [r for r in ttel.get_registry().snapshot()
                if r["name"] == "profiling/span_peak_bytes"]
    # without telemetry there is no tracer to wrap, and sampling still runs
    ttel.deconfigure()
    quiet = _engine(tmp_path, profiling={}, telemetry=False)
    quiet.train_batch(_batch())
    assert quiet._mem_profiler.samples == 1 and ttel.get_session() is None
