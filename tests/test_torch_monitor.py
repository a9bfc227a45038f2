"""The port's monitor writers and their engine wiring against the JAX
package's, on the CPU.

The same events go through both packages' TensorBoard, W&B and CSV writers:
the CSV files are byte for byte the same (one header, kept on reopen), the
TensorBoard event files hold the same scalars (read back with
TensorBoard's own reader; TensorFlow is hidden so that TensorBoard uses its
stub, as on a machine without it), and a stand-in ``wandb`` module sees the
same ``init`` and ``log`` calls. A writer whose library is absent warns and
disables itself in both. ``MonitorExporter`` turns one scripted registry
into the same ``Telemetry/*`` events in both. Three steps of gpt2-tiny
(fp32, the port's initial weights copied into the JAX model) write the
same ``Train/Samples/*`` series (losses rtol 1e-5, learning rates to their
fp32 rounding),
and ``telemetry.monitor`` the same ``Telemetry/*`` tags (losses rtol
1e-5, gradient norms 1e-4 as in ``test_torch_train.py``) (the JAX engine adds its ``device/*`` gauges, 0 on its
CPU backend; the port writes them on the card only); the JAX engine runs in
a fresh process (``tests/jax_process.py``). Without the blocks nothing is
written and neither library is imported.
"""

import csv
import logging
import os
import sys
import types

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.monitor import monitor as jmon
from deepspeed_tpu.runtime.config import MonitorConfig as JMonitorConfig
from deepspeed_tpu.telemetry.exporters import MonitorExporter as JMonitorExporter
from deepspeed_tpu.telemetry.registry import MetricsRegistry as JRegistry
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.monitor import monitor as tmon
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.runtime.config import MonitorConfig as TMonitorConfig
from deepspeed_tpu_torch.telemetry.exporters import MonitorExporter as TMonitorExporter
from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry as TRegistry
from tests.jax_process import JaxRun, save_tree

EVENTS = [("Train/Samples/train_loss", 5.25, 8), ("Train/Samples/lr", 1e-3, 8),
          ("Train/Samples/train_loss", 4.75, 16), ("Telemetry/serving/shed/reason=full", 3, 16)]
MORE = [("Train/Samples/train_loss", 4.5, 24), ("Train/Samples/lr", 5e-4, 24)]
TINY = dict(vocab_size=2048, n_positions=256, n_embd=128, n_layer=2, n_head=4, remat=False)
TRAIN_CONFIG = {"train_batch_size": 8, "steps_per_print": 0,
                "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}


def _configs(path, **blocks):
    """The same monitor blocks as (JAX's, the port's) MonitorConfig."""
    return (JMonitorConfig(**blocks),
            TMonitorConfig.from_dict(blocks))


class _Log(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def warnings_of_both():
    """The warnings each package's logger emits (neither propagates)."""
    from deepspeed_tpu.utils.logging import logger as jlog
    from deepspeed_tpu_torch.utils.logging import logger as tlog

    handlers = {"jax": _Log(), "torch": _Log()}
    jlog.addHandler(handlers["jax"])
    tlog.addHandler(handlers["torch"])
    yield handlers
    jlog.removeHandler(handlers["jax"])
    tlog.removeHandler(handlers["torch"])


def _csv_files(d):
    return {n: open(os.path.join(d, n), newline="").read() for n in sorted(os.listdir(d))}


def test_csv_writer_files_are_the_jax_files(tmp_path):
    files = {}
    for side, mod in (("jax", jmon), ("torch", tmon)):
        block = {"enabled": True, "output_path": str(tmp_path / side), "job_name": "job"}
        config = _configs(tmp_path, csv_monitor=block)[side == "torch"]
        master = mod.MonitorMaster(config)
        assert master.enabled and master.csv_monitor.enabled
        assert not (master.tb_monitor.enabled or master.wandb_monitor.enabled)
        master.write_events(EVENTS)
        master.csv_monitor.close()
        # a second writer over the same directory (a resumed run) appends
        # without a second header
        again = mod.MonitorMaster(config)
        again.write_events(MORE, flush=False)
        again.csv_monitor.close()
        files[side] = _csv_files(tmp_path / side / "job")
    assert files["torch"] == files["jax"]
    rows = list(csv.reader(files["torch"]["Train_Samples_train_loss.csv"].splitlines()))
    assert rows == [["step", "Train/Samples/train_loss"], ["8", "5.25"], ["16", "4.75"],
                    ["24", "4.5"]]
    assert "Telemetry_serving_shed_reason=full.csv" in files["torch"]


def test_tensorboard_writer_scalars_are_the_jax_scalars(tmp_path, monkeypatch):
    # TensorBoard's own stub in place of TensorFlow, as on a machine without it
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    scalars = {}
    for side, mod in (("jax", jmon), ("torch", tmon)):
        block = {"enabled": True, "output_path": str(tmp_path / side), "job_name": "tb"}
        jc, tc = _configs(tmp_path, tensorboard=block)
        master = mod.MonitorMaster(jc if side == "jax" else tc)
        assert master.enabled and master.tb_monitor.enabled
        master.write_events(EVENTS)
        master.write_events(MORE)
        master.tb_monitor.summary_writer.close()
        acc = EventAccumulator(str(tmp_path / side / "tb"))
        acc.Reload()
        scalars[side] = {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
                         for tag in acc.Tags()["scalars"]}
    assert scalars["torch"] == scalars["jax"]
    assert scalars["torch"]["Train/Samples/train_loss"] == [(8, 5.25), (16, 4.75), (24, 4.5)]


def _fake_wandb(calls):
    wandb = types.ModuleType("wandb")
    wandb.init = lambda **kw: calls.append(("init", kw))
    wandb.log = lambda data, step=None: calls.append(("log", data, step))
    return wandb


def test_wandb_writer_calls_are_the_jax_calls(tmp_path, monkeypatch):
    calls = {}
    for side, mod in (("jax", jmon), ("torch", tmon)):
        calls[side] = []
        monkeypatch.setitem(sys.modules, "wandb", _fake_wandb(calls[side]))
        jc, tc = _configs(tmp_path, wandb={"enabled": True, "project": "p", "group": "g",
                                           "team": "t"})
        master = mod.MonitorMaster(jc if side == "jax" else tc)
        assert master.enabled and master.wandb_monitor.enabled
        master.write_events(EVENTS)
    assert calls["torch"] == calls["jax"]
    assert calls["torch"][0] == ("init", {"project": "p", "group": "g", "entity": "t"})
    assert calls["torch"][1] == ("log", {"Train/Samples/train_loss": 5.25}, 8)


def test_absent_libraries_warn_and_disable_like_jax(tmp_path, monkeypatch, warnings_of_both):
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    states = {}
    for side, mod in (("jax", jmon), ("torch", tmon)):
        blocks = dict(tensorboard={"enabled": True, "output_path": str(tmp_path / side)},
                      wandb={"enabled": True},
                      csv_monitor={"enabled": True, "output_path": str(tmp_path / side)})
        jc, tc = _configs(tmp_path, **blocks)
        master = mod.MonitorMaster(jc if side == "jax" else tc)
        master.write_events(EVENTS)
        states[side] = (master.enabled, master.tb_monitor.enabled,
                        master.wandb_monitor.enabled, master.csv_monitor.enabled)
        master.csv_monitor.close()
    assert states["torch"] == states["jax"] == (True, False, False, True)
    for side in ("jax", "torch"):
        msgs = warnings_of_both[side].messages
        assert any(m.startswith("TensorBoard writer unavailable") for m in msgs), msgs
        assert any(m.startswith("wandb unavailable") for m in msgs), msgs


def test_monitor_blocks_parse_like_jax(tmp_path):
    blocks = {"tensorboard": {"enabled": True, "output_path": "o", "job_name": "j"},
              "wandb": {"enabled": False, "project": "x", "team": "t"},
              "csv_monitor": {"enabled": True}}
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig

    j = JConfig({"train_batch_size": 8, **blocks}).monitor_config
    t = TConfig({"train_batch_size": 8, **blocks}).monitor_config
    for block in ("tensorboard", "wandb", "csv_monitor"):
        assert vars(getattr(t, block)) == dict(getattr(j, block)), block
    empty = TConfig({"train_batch_size": 8}).monitor_config
    assert not (empty.tensorboard.enabled or empty.wandb.enabled or empty.csv_monitor.enabled)
    with pytest.raises(ValueError, match="did you mean 'job_name'"):
        TConfig({"train_batch_size": 8, "csv_monitor": {"job_nam": "x"}})


def _script(reg):
    reg.counter("serving/shed", labels={"reason": "full", "route": "a"}).inc(3)
    reg.counter("train/steps").inc()
    reg.gauge("train/loss").set(2.5)
    h = reg.histogram("serving/ttft_seconds", max_samples=8)
    for v in np.random.RandomState(0).lognormal(size=50):
        h.observe(float(v))


class _Recorder:
    enabled = True

    def __init__(self):
        self.events = []

    def write_events(self, events, flush=True):
        self.events.extend(events)


def test_monitor_exporter_tags_are_the_jax_tags():
    out = {}
    for side, Reg, Exp in (("jax", JRegistry, JMonitorExporter),
                           ("torch", TRegistry, TMonitorExporter)):
        reg, rec = Reg(default_max_samples=8), _Recorder()
        _script(reg)
        Exp(rec).export(reg.snapshot(), step=7)
        off = _Recorder()
        off.enabled = False
        Exp(off).export(reg.snapshot(), step=7)
        assert off.events == []
        out[side] = rec.events
    assert out["torch"] == out["jax"]
    assert ("Telemetry/serving/shed/reason=full/route=a", 3.0, 7) in out["torch"]
    assert any(t == "Telemetry/serving/ttft_seconds/p50" for t, _, _ in out["torch"])


_JAX_TRAINING = """
import numpy as np
import jax.numpy as jnp
import deepspeed_tpu
from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.models import gpt2 as jgpt2

cfg = jgpt2.GPT2Config(**INPUTS["tiny"], dtype=jnp.float32)
params = jax.tree.map(jnp.asarray, load_tree(INPUTS["params"]))
config = dict(INPUTS["config"])
config["csv_monitor"]["output_path"] = OUT
config["telemetry"]["output_dir"] = os.path.join(OUT, "telemetry")
engine, *_ = deepspeed_tpu.initialize(model=jgpt2.GPT2Model(cfg), model_parameters=params,
                                      config=config)
batch = {"input_ids": np.asarray(INPUTS["ids"], np.int32)}
for _ in range(3):
    engine.train_batch(batch)
jtel.deconfigure()
engine.monitor.csv_monitor.close()
d = os.path.join(OUT, "job")
RESULT = {n: open(os.path.join(d, n), newline="").read() for n in sorted(os.listdir(d))}
"""


def _rows(text):
    return [(int(s), float(v)) for s, v in list(csv.reader(text.splitlines()))[1:]]


def test_train_samples_and_telemetry_tags_equal_jax(tmp_path):
    ids = np.random.RandomState(0).randint(0, TINY["vocab_size"], size=(8, 32))
    blocks = {"csv_monitor": {"enabled": True, "job_name": "job"},
              "telemetry": {"enabled": True, "monitor": True, "flush_interval": 1}}
    config = {**TRAIN_CONFIG,
              "csv_monitor": {**blocks["csv_monitor"], "output_path": str(tmp_path / "torch")},
              "telemetry": {**blocks["telemetry"], "output_dir": str(tmp_path / "tel")}}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.GPT2Model(tgpt2.GPT2Config(**TINY, dtype=torch.float32)), config=config,
        device="cpu")
    params = str(tmp_path / "params.npz")
    save_tree(engine.module_state_dict(), params)
    jax_run = JaxRun(_JAX_TRAINING, str(tmp_path / "jax"), tiny=TINY, params=params,
                     config={**TRAIN_CONFIG, **blocks}, ids=ids.tolist())
    for _ in range(3):
        engine.train_batch({"input_ids": torch.tensor(ids)})
    ttel.deconfigure()
    engine.monitor.csv_monitor.close()
    got = _csv_files(tmp_path / "torch" / "job")
    want = jax_run.result()
    # losses rtol 1e-5 in fp32, the learning rate to its fp32 rounding (JAX
    # holds it in fp32, the port as a float), the gradient norm at
    # test_torch_train.py's 1e-4
    for tag, rtol in (("Train_Samples_train_loss.csv", 1e-5), ("Train_Samples_lr.csv", 1e-7),
                      ("Telemetry_train_loss.csv", 1e-5),
                      ("Telemetry_train_grad_norm.csv", 1e-4)):
        g, w = _rows(got[tag]), _rows(want[tag])
        assert [s for s, _ in g] == [s for s, _ in w], tag
        np.testing.assert_allclose([v for _, v in g], [v for _, v in w], rtol=rtol, err_msg=tag)
    assert [s for s, _ in _rows(got["Train_Samples_train_loss.csv"])] == [8, 16, 24]
    # the JAX engine's CPU backend also reports device/* gauges of 0
    assert set(got) == {n for n in want if not n.startswith("Telemetry_device_")}
    assert got["Telemetry_train_steps.csv"] == want["Telemetry_train_steps.csv"]


def test_without_blocks_nothing_is_written_and_no_library_is_imported(tmp_path,
                                                                     monkeypatch):
    libs = ("torch.utils.tensorboard", "wandb")
    saved = {m: sys.modules.pop(m) for m in libs if m in sys.modules}
    try:
        cfg = tgpt2.GPT2Config(**{**TINY, "vocab_size": 256}, dtype=torch.float32)
        engine, *_ = deepspeed_tpu_torch.initialize(model=tgpt2.GPT2Model(cfg),
                                                    config=dict(TRAIN_CONFIG), device="cpu")
        monkeypatch.chdir(tmp_path)
        engine.train_batch(tgpt2.synthetic_lm_batch(8, 16, 256))
        assert not engine.monitor.enabled
        assert not any(m in sys.modules for m in libs)
        assert os.listdir(tmp_path) == []
    finally:
        sys.modules.update(saved)
