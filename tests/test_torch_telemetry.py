"""The port's telemetry core against the JAX package's, on the CPU.

One scripted series (labelled counters, gauges, histograms past their
reservoir, a bounded histogram, spans) goes through both packages'
registries, tracers and exporters: the snapshots (p50/p90/p99 included:
the same seeded reservoir), the Prometheus text and the JSONL records are
identical, the timestamps aside, and so are the trace events but their
times. A disabled block installs nothing and the no-op registry takes
every call. Three training steps of ``initialize`` with the block write
the JAX engine's ``train/*`` series and spans (the JAX engine also writes
``device/*`` gauges of 0 where its CPU backend reports no memory; the
port writes them on the card only). An observed ``generate`` writes the
``inference/*`` series, and ``model_times()`` keeps the JAX contract.

The JAX engines whose spans are compared run in a fresh process
(``tests/jax_process.py``): a JAX ``goodput`` test earlier in the same
worker installs a process-wide compile listener that adds ``compile``
spans to every later JAX series, and the comparison holds with it
installed here.
"""

import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.runtime.config import TelemetryConfig as JTelemetryConfig
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.config import TelemetryConfig as TTelemetryConfig
from tests.jax_process import run_jax

SMALL = dict(vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=4)


@pytest.fixture(autouse=True)
def _no_sessions():
    yield
    jtel.deconfigure()
    ttel.deconfigure()


def _script(reg, tracer):
    """The same calls into either package's registry and tracer."""
    rng = np.random.RandomState(0)
    for i in range(7):
        reg.counter("serving/admitted").inc()
        reg.counter("serving/shed", labels={"reason": "queue_full" if i % 2 else "draining"}).inc()
        reg.counter("comm/bytes", labels={"op": "all_reduce", "group": "data"}).inc(1024.5)
    reg.gauge("serving/queue_depth").set(3)
    reg.gauge("train/loss").set(2.718281828)
    lat = reg.histogram("serving/ttft_seconds", max_samples=16)
    for v in rng.lognormal(size=100):
        lat.observe(float(v))
    sizes = reg.histogram("serving/tokens_per_request", bounds=[1, 8, 64, 512])
    for v in (0, 1, 7, 9, 64, 65, 600, 3):
        sizes.observe(v)
    with tracer.span("prefill", cat="serving", request="r-1"):
        pass
    tracer.complete("admission_wait", 1500.0, cat="serving", request="r-1")
    tracer.instant("watchdog_timeout", cat="resilience", kind="deadline")
    with tracer.span("fwd", step=3):
        pass


def test_scripted_series_identical_in_both_packages(tmp_path):
    from deepspeed_tpu.telemetry.exporters import JSONLExporter as JJSONL
    from deepspeed_tpu.telemetry.exporters import PrometheusExporter as JProm
    from deepspeed_tpu.telemetry.registry import MetricsRegistry as JReg
    from deepspeed_tpu.telemetry.tracing import StepTracer as JTracer
    from deepspeed_tpu_torch.telemetry import JSONLExporter as TJSONL
    from deepspeed_tpu_torch.telemetry import MetricsRegistry as TReg
    from deepspeed_tpu_torch.telemetry import PrometheusExporter as TProm
    from deepspeed_tpu_torch.telemetry import StepTracer as TTracer

    out = {}
    for side, Reg, Tracer, JSONL, Prom in (("jax", JReg, JTracer, JJSONL, JProm),
                                           ("torch", TReg, TTracer, TJSONL, TProm)):
        reg, tracer = Reg(default_max_samples=32), Tracer(max_events=3)
        _script(reg, tracer)
        snap = reg.snapshot()
        path = tmp_path / f"{side}.jsonl"
        JSONL(str(path)).export(snap, step=5)
        JSONL(str(path)).export(snap, step=6)
        records = [json.loads(line) for line in path.read_text().splitlines()]
        for r in records:
            assert isinstance(r.pop("ts"), float)
        prom = tmp_path / f"{side}.prom"
        Prom(str(prom)).export(snap)
        events = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                  for e in tracer.events]
        out[side] = (snap, records, prom.read_text(), events, tracer.dropped)
    assert out["torch"] == out["jax"]
    snap = {r["name"]: r for r in out["torch"][0] if not r["labels"]}
    assert snap["serving/ttft_seconds"]["count"] == 100
    assert snap["serving/tokens_per_request"]["bucket_counts"] == [2, 2, 2, 1, 1]
    assert out["torch"][4] == 1          # the span cap of 3 dropped the fourth
    assert "# TYPE ds_serving_ttft_seconds summary" in out["torch"][2]


def test_sessions_write_the_same_files(tmp_path):
    files = {}
    for side, tel, Cfg in (("jax", jtel, JTelemetryConfig), ("torch", ttel, TTelemetryConfig)):
        d = tmp_path / side
        cfg = Cfg(enabled=True, output_dir=str(d), flush_interval=2, histogram_max_samples=8)
        s = tel.configure(cfg)
        assert tel.get_session() is s and s.source == "config"
        _script(tel.get_registry(), tel.get_tracer())
        for step in (1, 2, 3, 4):
            s.step_end(step)            # flushes at 2 and 4
        tel.deconfigure()
        assert tel.get_session() is None
        records = [json.loads(line) for line in (d / "metrics.jsonl").read_text().splitlines()]
        files[side] = (sorted(os.listdir(d)), [{k: v for k, v in r.items() if k != "ts"}
                                               for r in records])
    assert files["torch"] == files["jax"]
    assert files["torch"][0] == ["metrics.jsonl", "metrics.prom", "trace.json"]


def test_disabled_block_is_the_noop_registry(tmp_path):
    assert ttel.configure(TTelemetryConfig(enabled=False, output_dir=str(tmp_path))) is None
    reg, tracer = ttel.get_registry(), ttel.get_tracer()
    assert not reg.enabled and isinstance(reg, ttel.NoopRegistry)
    assert isinstance(tracer, ttel.NoopTracer)
    reg.counter("x").inc()
    reg.gauge("y").set(1.0)
    reg.histogram("z").observe(2.0)
    with tracer.span("fwd"):
        pass
    assert reg.snapshot() == [] and len(reg) == 0
    ttel.flush()
    assert os.listdir(tmp_path) == []
    # a disabled block removes a config-installed session, not a manual one
    manual = ttel.TelemetrySession(TTelemetryConfig(enabled=True, output_dir=str(tmp_path)))
    ttel.install_session(manual)
    ttel.configure(TTelemetryConfig(enabled=False))
    assert ttel.get_session() is manual
    # the monitor fan-out parses; without a monitor the session adds no exporter
    cfg = TTelemetryConfig.from_dict({"enabled": True, "monitor": True,
                                      "output_dir": str(tmp_path / "m")})
    assert cfg.monitor and not any(isinstance(e, ttel.MonitorExporter)
                                   for e in ttel.TelemetrySession(cfg).exporters)


_TRAIN_CONFIG = {"train_batch_size": 8, "steps_per_print": 0,
                 "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}


def _training_series(d):
    """(the train/* series with their kinds, the steps and values of
    train/steps, the names of the complete spans) of a run's files."""
    records = [json.loads(line) for line in open(os.path.join(d, "metrics.jsonl"))]
    trace = json.load(open(os.path.join(d, "trace.json")))
    return [[list(nk) for nk in sorted({(r["name"], r["kind"]) for r in records
                                        if r["name"].startswith("train/")})],
            [r["step"] for r in records if r["name"] == "train/steps"],
            [r["value"] for r in records if r["name"] == "train/steps"],
            [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"]]


_JAX_TRAINING = inspect.getsource(_training_series) + """
import numpy as np
import deepspeed_tpu
from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.models.simple import SimpleModel

batch = (np.ones((8, 16), np.float32), np.zeros((8, 16), np.float32))
train_dir = os.path.join(OUT, "training")
config = {**INPUTS["config"], "telemetry": {"enabled": True, "output_dir": train_dir,
                                            "flush_interval": 1}}
engine, *_ = deepspeed_tpu.initialize(model=SimpleModel(hidden_dim=16, nlayers=2), config=config)
for _ in range(3):
    engine.train_batch(batch)
jtel.deconfigure()
TRAINING = _training_series(train_dir)
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX engines' series of this module, from one fresh process:
    {"training": the 3 steps' series, "generate": the observed generate's}."""
    ids = np.random.RandomState(0).randint(0, 256, size=(2, 6)).astype(np.int32)
    out = tmp_path_factory.mktemp("jax")
    result = run_jax(_JAX_TRAINING + _JAX_GENERATE, str(out), config=_TRAIN_CONFIG,
                     small=SMALL, ids=ids.tolist())
    return {**result, "ids": ids, "params": os.path.join(out, "params.npz")}


def _compare_training_series(tmp_path, want):
    from deepspeed_tpu_torch.models.simple import SimpleModel as TSimple

    batch = (np.ones((8, 16), np.float32), np.zeros((8, 16), np.float32))
    d = tmp_path / "torch"
    config = {**_TRAIN_CONFIG, "telemetry": {"enabled": True, "output_dir": str(d),
                                             "flush_interval": 1}}
    engine, *_ = deepspeed_tpu_torch.initialize(model=TSimple(hidden_dim=16, nlayers=2),
                                                config=config, device="cpu")
    for _ in range(3):
        engine.train_batch(batch)
    ttel.deconfigure()
    got = json.loads(json.dumps(_training_series(str(d))))
    assert got == want
    names, steps, counts, spans = got
    assert [n for n, _ in names] == ["train/grad_norm", "train/loss", "train/lr",
                                     "train/samples", "train/steps"]
    # a flush each step (flush_interval 1), and the deconfigure's at the end
    assert steps == [1, 2, 3, 3] and counts == [1.0, 2.0, 3.0, 3.0]
    assert spans == ["data", "train_batch"] * 3


def test_training_steps_write_the_jax_series(tmp_path, jax_side):
    _compare_training_series(tmp_path, jax_side["training"])


def test_span_comparison_holds_with_the_compile_listener_installed(tmp_path, jax_side):
    """The JAX goodput meter's process-wide compile listener, installed in
    this process first (as an earlier test in the worker may), leaves the
    comparison as it is: the JAX series are built in a fresh process. The
    listener is removed again afterwards unless it was there before."""
    import jax.monitoring as mon
    from jax._src import monitoring as _mon

    from deepspeed_tpu.goodput import recorder

    was = recorder._LISTENER["installed"]
    before = list(_mon.get_event_duration_listeners())
    assert recorder.install_compile_listener()
    try:
        # the listener is live in this process: a JAX compile here with a
        # session on adds a compile span (what broke the in-process comparison)
        jtel.configure(JTelemetryConfig(enabled=True, output_dir=str(tmp_path / "probe")))
        jax.jit(lambda x: x * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()
        assert "compile" in [e["name"] for e in jtel.get_tracer().events]
        jtel.deconfigure()
        _compare_training_series(tmp_path, jax_side["training"])
    finally:
        if not was:
            for cb in _mon.get_event_duration_listeners():
                if cb not in before:
                    mon.unregister_event_duration_listener(cb)
            recorder._LISTENER["installed"] = False


_JAX_GENERATE = """
import numpy as np
import jax.numpy as jnp
import deepspeed_tpu
from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime.config import TelemetryConfig

jcfg = jgpt2.GPT2Config(**INPUTS["small"], dtype=jnp.float32, remat=False)
params = jgpt2.GPT2Model(jcfg).init_params(jax.random.PRNGKey(0))
np.savez(os.path.join(OUT, "params.npz"), **{
    "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]})
eng = deepspeed_tpu.init_inference(jgpt2.GPT2Model(jcfg),
                                   config={"dtype": "float32", "max_out_tokens": 32},
                                   params=params)
ids = np.asarray(INPUTS["ids"], np.int32)
try:
    eng.model_times()
    refused = ""
except AssertionError as e:
    refused = str(e)
jtel.configure(TelemetryConfig(enabled=True, output_dir=os.path.join(OUT, "generate")))
out = np.asarray(eng.generate(ids, max_new_tokens=5))
eng.profile_model_time()
eng.generate(ids, max_new_tokens=5)
eng.forward(ids)
times = eng.model_times()
snap = {r["name"]: r for r in jtel.get_registry().snapshot()}
spans = [(e["name"], e["cat"], e["args"]) for e in jtel.get_tracer().events]
jtel.deconfigure()
RESULT = {"training": TRAINING,
          "generate": [out.tolist(), refused, all(t > 0 for t in times), len(times),
                       eng.model_times(),
                       {n: (r.get("value"), r.get("count")) for n, r in snap.items()}, spans]}
"""


def _params_from_npz(path) -> dict:
    """The JAX params tree (``wte``, ``blocks/<key>`` ...) from the flat npz."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *heads, leaf = key.split("/")
            for h in heads:
                node = node.setdefault(h, {})
            node[leaf] = z[key]
    return tree


def test_observed_generate_and_model_times(tmp_path, jax_side):
    ids, want = jax_side["ids"], jax_side["generate"]
    te = deepspeed_tpu_torch.init_inference(
        tgpt2.params_from_jax(_params_from_npz(jax_side["params"]),
                              tgpt2.GPT2Config(**SMALL, dtype=torch.float32)),
        {"dtype": "float32", "max_out_tokens": 32}, device="cpu")
    with pytest.raises(AssertionError, match="profile_model_time") as refused:
        te.model_times()
    ttel.configure(TTelemetryConfig(enabled=True, output_dir=str(tmp_path / "torch")))
    out = np.asarray(te.generate(ids, max_new_tokens=5))
    te.profile_model_time()
    te.generate(ids, max_new_tokens=5)
    te.forward(ids)
    times = te.model_times()
    snap = {r["name"]: r for r in ttel.get_registry().snapshot()}
    spans = [(e["name"], e["cat"], e["args"]) for e in ttel.get_tracer().events]
    ttel.deconfigure()
    got = json.loads(json.dumps(
        [out.tolist(), str(refused.value), all(t > 0 for t in times), len(times),
         te.model_times(), {n: (r.get("value"), r.get("count")) for n, r in snap.items()},
         spans]))
    assert "profile_model_time" in want[1] and want[2]
    assert got == want
    series = got[5]
    assert series["inference/requests"] == [4.0, None]
    assert series["inference/generated_tokens"] == [20.0, None]
    for h in ("ttft_seconds", "decode_per_token_seconds", "request_seconds"):
        assert series[f"inference/{h}"] == [None, 2]
    assert got[6] == [["prefill", "inference", {"tokens": 6}],
                      ["decode", "inference", {"tokens": 5}]] * 2
