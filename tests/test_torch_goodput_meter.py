"""The goodput meter in the port's engine (the ``goodput`` ds_config block).

* The ``goodput/*`` series lag one step: after ``train_batch`` returns
  step k's loss, they hold step k - 1's ledger, which closes on its window.
* A meter exports, for the same ledger, the series JAX's exports (names,
  labels and values).
* The compile spans: with the flag armed, a kernel library built inside a
  step (its ``nvcc`` run and its load, through ``CudaKernel.load``) and a
  CUDA graph capture (``op_builder.stamp_compile``, the capture site's
  call) land in that step's ``compile`` bucket, at least 0.9 of the build's
  ``build_seconds``.
* In a fresh interpreter: the block absent imports no goodput module and
  leaves the flag unarmed; ``enabled: false`` likewise; ``compile_spans:
  false`` imports the meter and still stamps no span; the default arms the
  flag. ``offload_param: nvme`` refuses the block.
* MFU: the flops profiler's count over the card's peak times the world,
  over the step's wall; none on the CPU or before the count.
"""

import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.ops import op_builder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2, n_head=2, remat=False,
             use_flash_attention=False)
BUILD_S = 0.2


def _engine(tmp_path, **blocks):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2 as tgpt2

    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32)).init_params(
        torch.Generator().manual_seed(0))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, device="cpu", config={
        "train_batch_size": 8, "steps_per_print": 0,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
        "telemetry": {"enabled": True, "output_dir": str(tmp_path), "flush_interval": 1000},
        **blocks})
    return engine


def _batch():
    return {"input_ids": np.random.RandomState(0).randint(0, SMALL["vocab_size"], (8, 32))}


@pytest.fixture(autouse=True)
def _no_session():
    yield
    telemetry.deconfigure()


def _gauge(name, labels=None):
    for rec in telemetry.get_registry().snapshot():
        if rec["name"] == name and (rec.get("labels") or {}) == (labels or {}):
            return rec["value"]
    return None


def test_series_lag_one_step_and_close(tmp_path):
    from deepspeed_tpu_torch.goodput.taxonomy import BUCKETS

    engine = _engine(tmp_path, goodput={})
    engine.train_batch(_batch())
    assert _gauge("goodput/step") is None          # step 0's train_batch span was open
    for k in range(1, 4):
        engine.train_batch(_batch())
        assert _gauge("goodput/step") == k - 1
    fractions = {b: _gauge("goodput/fraction", {"bucket": b}) for b in BUCKETS}
    assert sum(fractions.values()) == pytest.approx(1.0, abs=1e-9)
    assert _gauge("goodput/goodput_fraction") == fractions["compute"] > 0.5
    assert _gauge("goodput/closure_violations") is None


def test_the_meter_exports_what_the_jax_meter_exports():
    from deepspeed_tpu.goodput.recorder import GoodputMeter as JMeter
    from deepspeed_tpu.runtime.config import GoodputConfig as JConfig
    from deepspeed_tpu.telemetry.registry import MetricsRegistry as JRegistry
    from deepspeed_tpu_torch.goodput.recorder import GoodputMeter as TMeter
    from deepspeed_tpu_torch.runtime.config import GoodputConfig as TConfig
    from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry as TRegistry

    led = {"step": 4, "start_us": 100.0, "wall_us": 2000.0,
           "buckets": {"compile": 300.0, "data_wait": 100.0, "exposed_comm": 250.0,
                       "compute": 1300.0, "idle": 50.0}}
    bad = dict(led, step=5, buckets={"compute": 100.0})      # misses its window by 95%
    snaps = []
    for meter, reg in ((TMeter(TConfig(compile_spans=False)), TRegistry()),
                       (JMeter(JConfig(compile_spans=False)), JRegistry())):
        meter._export(reg, led)
        meter._export(reg, bad)
        snaps.append([{k: v for k, v in rec.items() if k != "ts"} for rec in reg.snapshot()])
    assert snaps[0] == snaps[1]
    assert any(r["name"] == "goodput/closure_violations" and r["value"] == 1 for r in snaps[0])


class _FakeBuild(op_builder.CudaKernel):
    """A kernel library whose ``nvcc`` run is a sleep of BUILD_S and whose
    load is a stub: ``op_builder``'s own timing and stamping around them."""

    @property
    def library_path(self):
        return os.path.join(REPO, "goodput_probe.so")     # never written: CDLL is a stub

    def start_build(self):
        return "nvcc"

    def finish_build(self, proc):
        time.sleep(BUILD_S)


class _Lib:
    def __getattr__(self, name):
        return types.SimpleNamespace(argtypes=None, restype=None)


def test_builds_and_captures_inside_a_step_land_in_compile(tmp_path, monkeypatch):
    from deepspeed_tpu_torch.goodput.ledger import step_ledgers

    engine = _engine(tmp_path, goodput={})
    assert op_builder._COMPILE_SPANS[0]
    kern = _FakeBuild("goodput_probe", {})
    op_builder._KERNELS.remove(kern)
    monkeypatch.setattr(op_builder.ctypes, "CDLL", lambda path: _Lib())
    loss = engine.module.loss

    def loss_building_first(batch, **kw):
        if kern._lib is None:
            kern.load()                                  # the first launch builds
            op_builder.stamp_compile("cuda_graph_capture", 0.05)
            time.sleep(0.05)
        return loss(batch, **kw)

    monkeypatch.setattr(engine.module, "loss", loss_building_first)
    for _ in range(3):
        engine.train_batch(_batch())
    events = telemetry.get_tracer().events
    spans = [e for e in events if e.get("cat") == "compile"]
    assert sorted(e["args"]["phase"] for e in spans) == ["cuda_graph_capture", "load", "nvcc"]
    assert kern.build_seconds >= BUILD_S and kern.load_seconds is not None
    ledgers = step_ledgers(events)
    assert [led["step"] for led in ledgers] == [0, 1, 2]
    assert ledgers[0]["buckets"]["compile"] >= 0.9 * kern.build_seconds * 1e6
    assert ledgers[1]["buckets"]["compile"] == ledgers[2]["buckets"]["compile"] == 0.0


_STRICT = """
import json, sys
import numpy as np, torch
import deepspeed_tpu_torch
from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import op_builder

SMALL = json.loads(sys.argv[1])
out = {}
for name, block in (("absent", None), ("disabled", {"enabled": False}),
                    ("no_compile_spans", {"compile_spans": False}), ("default", {})):
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32))
    config = {"train_batch_size": 8, "steps_per_print": 0,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "telemetry": {"enabled": True, "output_dir": sys.argv[2] + "/" + name}}
    if block is not None:
        config["goodput"] = block
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, device="cpu", config=config)
    engine.train_batch({"input_ids": np.zeros((8, 16), np.int64)})
    op_builder.stamp_compile("nvcc", 0.01)
    out[name] = {"modules": sorted(m for m in sys.modules
                                   if m.startswith("deepspeed_tpu_torch.goodput")),
                 "armed": op_builder._COMPILE_SPANS[0],
                 "meter": engine._goodput is not None,
                 "compile_spans": len([e for e in telemetry.get_tracer().events
                                       if e.get("cat") == "compile"])}
    telemetry.deconfigure()
print(json.dumps(out))
"""


def test_the_block_absent_is_a_strict_no_op(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _STRICT, json.dumps(SMALL), str(tmp_path)],
                          capture_output=True, text=True, timeout=120, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("absent", "disabled"):
        assert out[name] == {"modules": [], "armed": False, "meter": False,
                             "compile_spans": 0}, name
    assert out["no_compile_spans"]["meter"] and not out["no_compile_spans"]["armed"]
    assert out["no_compile_spans"]["compile_spans"] == 0
    assert "deepspeed_tpu_torch.goodput.recorder" in out["no_compile_spans"]["modules"]
    assert out["default"]["armed"] and out["default"]["compile_spans"] == 1


def test_the_block_parses_with_jax_defaults_and_bounds():
    from deepspeed_tpu.runtime.config import GoodputConfig as JConfig
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, GoodputConfig

    got, want = GoodputConfig.from_dict({}), JConfig()
    assert (got.enabled, got.compile_spans, got.tolerance) == \
        (want.enabled, want.compile_spans, want.tolerance)
    for bad in (0.0, 1.5, -0.1):
        with pytest.raises(ValueError, match="tolerance"):
            GoodputConfig.from_dict({"tolerance": bad})
    with pytest.raises(ValueError, match="tolerence"):
        GoodputConfig.from_dict({"tolerence": 0.1})
    cfg = DeepSpeedConfig({"train_batch_size": 8, "goodput": {"tolerance": 0.1}})
    assert cfg.goodput_present and cfg.goodput.tolerance == 0.1
    assert not DeepSpeedConfig({"train_batch_size": 8}).goodput_present


def test_zero_infinity_refuses_the_block(tmp_path):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2 as tgpt2

    with pytest.raises(NotImplementedError, match="goodput"):
        deepspeed_tpu_torch.initialize(
            model=tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32)),
            device="cpu", config={"train_batch_size": 8, "goodput": {},
                                  "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
                                  "zero_optimization": {"stage": 3, "offload_param": {
                                      "device": "nvme", "nvme_path": str(tmp_path)}}})


def test_mfu_is_the_flops_count_over_the_peak(monkeypatch):
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.goodput.recorder import GoodputMeter
    from deepspeed_tpu_torch.runtime.config import GoodputConfig

    timer = types.SimpleNamespace(flops_per_batch=None)
    engine = types.SimpleNamespace(tput_timer=timer, device=torch.device("cuda", 0),
                                   train_dtype=torch.bfloat16, dp_world_size=2)
    meter = GoodputMeter(GoodputConfig(compile_spans=False), engine=engine)
    assert meter._mfu(0.5) is None                   # no count before the profiled step
    monkeypatch.setattr(type(get_accelerator()), "peak_flops",
                        lambda self, dtype=None: {torch.bfloat16: 1e15}[dtype])
    timer.flops_per_batch = 2e14
    assert meter._mfu(0.5) == pytest.approx(2e14 * 2 / (1e15 * 2) / 0.5)
    cpu = GoodputMeter(GoodputConfig(compile_spans=False), engine=types.SimpleNamespace(
        tput_timer=timer, device=torch.device("cpu"), train_dtype=torch.float32,
        dp_world_size=1))
    assert cpu._mfu(0.5) is None
