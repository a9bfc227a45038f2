"""The port's resilience blocks against the JAX package's, as units on the
CPU: the config blocks, the bad-step sentinel, the chaos injector's new
fault classes and hooks, the step watchdog and the heartbeat.

The ``watchdog``, ``rewind``, ``elasticity``, ``resilience.sentinel`` and
``resilience.chaos`` blocks parse as JAX's (defaults, bounds, unknown keys
with a did-you-mean hint), and the knobs of a later slice raise. The same
loss and overflow sequences trip the sentinel at the same steps; the same
seed and script give the JAX injector's fault sequence, hooks and
truncation lengths; the same step times give the same deadlines. A hang
under the watchdog ends in the dump, the counter and a clean
``WatchdogTimeout``; ``on_timeout: "kill"`` escalates (the kill replaced).
"""

import dataclasses
import math
import os
import signal
import threading
import time

import numpy as np
import pytest

from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.resilience import chaos as jchaos
from deepspeed_tpu.resilience import sentinel as jsentinel
from deepspeed_tpu.resilience import watchdog as jwd
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.config import TelemetryConfig as JTelemetryConfig
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.resilience import chaos as tchaos
from deepspeed_tpu_torch.resilience import sentinel as tsentinel
from deepspeed_tpu_torch.resilience import watchdog as twd
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.runtime.config import TelemetryConfig as TTelemetryConfig


@pytest.fixture(autouse=True)
def _clean():
    yield
    jtel.deconfigure()
    ttel.deconfigure()
    jchaos.uninstall_chaos()
    tchaos.uninstall_chaos()


# ----------------------------------------------------------------- config
BLOCKS = {
    "watchdog": {"enabled": True, "step_timeout_factor": 2.5, "window": 8,
                 "on_timeout": "kill", "heartbeat_file": "/tmp/hb", "consistency_interval": 3},
    "rewind": {"ram_interval": 3, "keep": 4, "emergency_fresh": False},
    "elasticity": {"enabled": True, "max_train_batch_size": 64, "micro_batch_sizes": [2, 4],
                   "min_gpus": 1, "max_gpus": 8, "prefer_larger_batch_size": False},
}


def _fields(obj) -> dict:
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return obj


def _jfields(obj, keys) -> dict:
    return {k: getattr(obj, k) for k in keys}


@pytest.mark.parametrize("block", ["watchdog", "rewind"])
@pytest.mark.parametrize("given", ["defaults", "set"])
def test_watchdog_and_rewind_blocks_parse_like_jax(block, given):
    pd = {"train_batch_size": 8, block: {} if given == "defaults" else dict(BLOCKS[block])}
    t, j = getattr(TConfig(pd), block), getattr(JConfig(pd), block)
    got = _fields(t)
    assert got == _jfields(j, got)
    assert TConfig(pd).rewind_present == JConfig(pd).rewind_present


def test_elasticity_block_parses_like_jax():
    from deepspeed_tpu.elasticity.config import ElasticityConfig as JElastic

    t = TConfig({"train_batch_size": 8, "elasticity": BLOCKS["elasticity"]}).elasticity_config
    j = JElastic(**BLOCKS["elasticity"])
    for k in ("enabled", "max_train_batch_size", "micro_batch_sizes", "min_gpus", "max_gpus",
              "min_time", "version", "prefer_larger_batch", "ignore_non_elastic_batch_info",
              "model_parallel_size", "num_gpus_per_node"):
        assert getattr(t, k) == getattr(j, k), k
    assert TConfig({"train_batch_size": 8}).elasticity_config is None


@pytest.mark.parametrize("sub", ["sentinel", "chaos"])
def test_resilience_sub_blocks_parse_like_jax(sub):
    given = {"sentinel": {"enabled": True, "patience": 2, "spike_factor": 1.5, "window": 6},
             "chaos": {"enabled": True, "seed": 3, "truncate_rate": 0.2, "hang_rate": 0.1,
                       "preempt_rate": 0.05, "ops": ["latest", "train_step"]}}[sub]
    for pd in ({}, {sub: given}):
        t = getattr(TConfig({"train_batch_size": 8, "resilience": pd}).resilience, sub)
        j = getattr(JConfig({"train_batch_size": 8, "resilience": pd}).resilience, sub)
        got = _fields(t)
        assert got == _jfields(j, got), pd


BAD = [
    ({"watchdog": {"enabled": True, "windw": 8}}, ValueError, "did you mean 'window'"),
    ({"watchdog": {"on_timeout": "abort"}}, ValueError, "on_timeout"),
    ({"watchdog": {"window": 2}}, ValueError, "window"),
    ({"watchdog": {"step_timeout_percentile": 1.5}}, ValueError, "percentile"),
    ({"rewind": {"ram_intervall": 3}}, ValueError, "ram_interval"),
    ({"rewind": {"keep": 0}}, ValueError, "keep"),
    ({"resilience": {"sentinel": {"patience": 0}}}, ValueError, "patience"),
    ({"resilience": {"chaos": {"truncate_rate": 2.0}}}, ValueError, "truncate_rate"),
    ({"resilience": {"chaos": {"shrink_at_step": 3}}}, ValueError, "shrink_to"),
    ({"elasticity": {"min_gpus": 4, "max_gpus": 2}}, Exception, "min_gpus"),
    ({"elasticity": {"micro_batch_size": [2]}}, ValueError, "micro_batch_sizes"),
]


@pytest.mark.parametrize("case", range(len(BAD)), ids=[str(i) for i in range(len(BAD))])
def test_bad_blocks_rejected_with_the_jax_checks(case):
    extra, exc, match = BAD[case]
    with pytest.raises(exc, match=match):
        TConfig({"train_batch_size": 8, **extra})


LATER = [
    {"resilience": {"chaos": {"enabled": True, "shrink_at_step": 3, "shrink_to": 2}}},
    {"resilience": {"chaos": {"enabled": True, "bitflip_at_step": 2, "bitflip_rate": 1.0}}},
    {"resilience": {"chaos": {"enabled": True, "slow_from_step": 2, "slow_factor": 5.0}}},
    {"resilience": {"chaos": {"enabled": True, "collective_mismatch": True}}},
    {"elasticity": {"resize": {"enabled": True}}},
]


@pytest.mark.parametrize("case", range(len(LATER)), ids=[str(i) for i in range(len(LATER))])
def test_knobs_of_several_devices_raise(case):
    JConfig({"train_batch_size": 8, **LATER[case]})            # the JAX package takes them
    with pytest.raises(NotImplementedError, match="later slice"):
        TConfig({"train_batch_size": 8, **LATER[case]})


# --------------------------------------------------------------- sentinel
SEQUENCES = {
    "nan_streak": [(2.0, False), (1.9, False), (math.nan, False), (math.nan, False),
                   (math.inf, False), (1.8, False), (math.nan, False)],
    "warmup_overflow": [(5.0, True), (5.0, True), (4.0, False), (3.9, True), (3.8, True),
                        (3.7, True), (3.6, False)],
    "spikes": [(4.0, False), (3.9, False), (3.8, False), (3.7, False), (9.0, False),
               (3.6, False), (8.0, False), (8.5, False), (3.5, False), (12.0, False)],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
@pytest.mark.parametrize("kw", [dict(patience=1), dict(patience=2, spike_factor=2.0, window=4),
                                dict(patience=3, spike_factor=1.5, window=8)])
def test_sentinel_trips_where_jax_trips(name, kw):
    runs = []
    for mod in (jsentinel, tsentinel):
        s = mod.BadStepSentinel(**kw)
        trips = []
        for i, (loss, overflow) in enumerate(SEQUENCES[name]):
            if s.observe(loss, overflow):
                trips.append((i, s.last_reason))
                s.reset()
        runs.append((trips, s.trips, s.bad_streak))
    assert runs[0] == runs[1]
    with pytest.raises(ValueError, match="patience"):
        tsentinel.BadStepSentinel(patience=0)


# ------------------------------------------------------------------ chaos
IO_OPS = ("state_save", "client_state", "sampler_sidecar", "manifest", "latest",
          "emergency_save")
SCRIPTS = {
    "io_rates": dict(failure_rate=0.2, truncate_rate=0.3, delay_rate=0.2, max_delay_s=0.0),
    "io_scripted": dict(fail_at={"latest": [2]}, truncate_at={"client_state": [1, 3],
                                                              "emergency_save": [2]},
                        truncate_rate=0.1),
    "step_rates": dict(hang_rate=0.2, hang_s=0.0, preempt_rate=0.2, failure_rate=0.1,
                       ops=["train_step", "state_save", "latest"]),
    "step_scripted": dict(hang_at={"train_step": [2]}, hang_s=0.0,
                          preempt_at={"train_step": [4]}, kill_at={"train_step": [5]},
                          delay_at={"train_step": [3]}, max_delay_s=0.0, truncate_rate=0.5),
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_chaos_sequence_equals_jax(monkeypatch, tmp_path, script, seed):
    """The same calls through both injectors (os.kill replaced, so preempt
    and kill are recorded, not delivered): the same faults, hooks,
    truncation lengths, counts and series."""
    got = {}
    for side, chaos, tel, Cfg in (("jax", jchaos, jtel, JTelemetryConfig),
                                  ("torch", tchaos, ttel, TTelemetryConfig)):
        sent = []
        monkeypatch.setattr(os, "kill", lambda pid, sig: sent.append(sig))
        tel.configure(Cfg(enabled=True, output_dir=str(tmp_path / side)))
        inj = chaos.ChaosInjector(seed=seed, **SCRIPTS[script])
        fired = []
        for i in range(24):
            for op in ("train_step", *IO_OPS):
                if op == "train_step" and not inj.targets(op):
                    continue
                try:
                    inj.before(op, f"{op}-{i}")
                    fired.append((op, len(inj.corrupt(op, f"{op}-{i}", b"x" * (100 + i)))))
                except chaos.ChaosError as e:
                    fired.append((op, str(e)))
        snap = {(r["name"], tuple(sorted(r["labels"].items()))): r.get("value")
                for r in tel.get_registry().snapshot()}
        got[side] = (fired, [(op, a[:5] if a.startswith("delay") else a, p)
                             for op, a, p in inj.log],
                     dict(inj._counts), snap, sent)
        tel.deconfigure()
    assert got["torch"] == got["jax"]
    actions = {a.split()[0] for _, a, _ in got["torch"][1]}
    assert actions >= ({"truncate"} if "truncate" in str(SCRIPTS[script]) else {"hang"})


def test_preempt_and_kill_send_their_signals(monkeypatch):
    sent = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: sent.append((pid, sig)))
    inj = tchaos.ChaosInjector(preempt_at={"train_step": [1]}, kill_at={"train_step": [2]})
    inj.before("train_step", "step=1")
    inj.before("train_step", "step=2")
    assert sent == [(os.getpid(), signal.SIGTERM), (os.getpid(), signal.SIGKILL)]
    assert [a for _, a, _ in inj.log] == ["preempt", "kill"]


def test_preempt_rate_is_step_oriented():
    """A preempt rate without ops fires on the step hook only (JAX's
    contract): a checkpoint-I/O drill never grows a SIGTERM."""
    fired = []
    orig = signal.signal(signal.SIGTERM, lambda *_: fired.append(1))
    try:
        inj = tchaos.ChaosInjector(preempt_rate=1.0)
        assert inj.targets("train_step") and inj.targets("decode_step")
        inj.before("latest", "p")
        assert not fired
        inj.before("train_step", "step=1")
        assert fired and ("train_step", "preempt", "step=1") in inj.log
    finally:
        signal.signal(signal.SIGTERM, orig)


def test_targets_gates_the_step_hook():
    for chaos in (jchaos, tchaos):
        assert not chaos.ChaosInjector(failure_rate=0.9).targets("train_step")
        assert chaos.ChaosInjector(hang_at={"train_step": [1]}).targets("train_step")
        assert chaos.ChaosInjector(failure_rate=0.9, ops=["train_step"]).targets("train_step")
        assert not chaos.ChaosInjector(failure_rate=0.9, ops=["latest"]).targets("train_step")
        assert chaos.ChaosInjector(hang_rate=0.1).targets("train_step")


def test_from_config_installs_like_jax():
    block = {"enabled": True, "seed": 5, "failure_rate": 0.3, "truncate_rate": 0.2,
             "preempt_rate": 0.1, "ops": ["latest"]}
    t = tchaos.ChaosInjector.from_config(
        TConfig({"train_batch_size": 8, "resilience": {"chaos": block}}).resilience.chaos)
    j = jchaos.ChaosInjector.from_config(
        JConfig({"train_batch_size": 8, "resilience": {"chaos": block}}).resilience.chaos)
    for k in ("seed", "failure_rate", "truncate_rate", "preempt_rate", "ops", "hang_s",
              "max_delay_s", "source"):
        assert getattr(t, k) == getattr(j, k), k


def test_truncated_write_fails_its_manifest(tmp_path):
    """The corrupt hook in the atomic writes and the streamed write: the
    write lands truncated and the manifest's hash catches it."""
    from deepspeed_tpu_torch.resilience import fsio, manifest

    tchaos.install_chaos(tchaos.ChaosInjector(truncate_at={"client_state": [1],
                                                           "emergency_save": [1]}))
    tag = tmp_path / "t"
    (tag / "state").mkdir(parents=True)
    (tag / "state" / "_CHECKPOINT_METADATA").write_text("{}")
    data = b"y" * 1000
    fsio.atomic_write_bytes(str(tag / "client_state.json"), data, op="client_state")
    streamed = fsio.atomic_write_stream(str(tag / "state" / "blob"),
                                        lambda f: [f.write(b"z" * 500) for _ in range(4)],
                                        op="emergency_save")
    assert streamed[0] == 2000 and os.path.getsize(tag / "state" / "blob") < 2000
    assert os.path.getsize(tag / "client_state.json") < 1000
    manifest.write_manifest(str(tag), "t", {"client_state.json": data,
                                            "state/blob": streamed})
    ok, reason = manifest.verify_tag(str(tag))
    assert not ok and ("mismatch" in reason or "manifest says" in reason)


# --------------------------------------------------------------- watchdog
@pytest.mark.parametrize("kw,durations", [
    (dict(factor=2.0, percentile=0.5, window=8, min_timeout=0.1, startup_timeout=99.0),
     [1.0, 2.0, 3.0, 4.0]),
    (dict(min_timeout=50.0), [0.001]),
    (dict(factor=3.0, percentile=0.95, window=4, min_timeout=0.5),
     [0.2, 0.9, 0.3, 0.4, 0.5, 0.25]),
])
def test_deadlines_equal_jax(kw, durations):
    j, t = jwd.StepWatchdog(**kw), twd.StepWatchdog(**kw)
    seen = [(j.deadline_s(), t.deadline_s())]
    for d in durations:
        j.observe(d)
        t.observe(d)
        seen.append((j.deadline_s(), t.deadline_s()))
    assert all(a == b for a, b in seen)
    with pytest.raises(ValueError):
        twd.StepWatchdog(on_timeout="abort")


def test_never_armed_watchdog_owns_no_thread():
    before = threading.active_count()
    twd.StepWatchdog(min_timeout=0.1)
    assert threading.active_count() == before


def test_hang_fires_dump_counter_and_clean_timeout(tmp_path):
    ttel.configure(TTelemetryConfig(enabled=True, output_dir=str(tmp_path / "t"), trace=False))
    dump = str(tmp_path / "stacks.txt")
    w = twd.StepWatchdog(min_timeout=0.3, startup_timeout=0.3, dump_path=dump)
    w.arm()
    t0 = time.monotonic()
    with pytest.raises(twd.WatchdogTimeout, match="deadline"):
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:         # an interruptible host stall
            time.sleep(0.02)
    assert time.monotonic() - t0 < 5.0
    w.disarm()
    w.close()
    assert w.trips == 1 and "watchdog stack dump" in open(dump).read()
    snap = {(r["name"], tuple(sorted(r["labels"].items()))): r["value"]
            for r in ttel.get_registry().snapshot()}
    assert snap[("resilience/watchdog_timeouts", (("kind", "step"),))] == 1


def test_on_timeout_kill_escalates():
    killed = []
    w = twd.StepWatchdog(min_timeout=0.2, startup_timeout=0.2, on_timeout="kill")
    w._kill = lambda: killed.append(True)
    w.arm()
    time.sleep(0.6)
    w.close()
    assert killed == [True] and w.trips == 1


def test_extend_and_late_completion(monkeypatch):
    w = twd.StepWatchdog(min_timeout=0.2, startup_timeout=5.0)
    assert w.extend_if_armed() is False
    w.arm()
    assert w.extend_if_armed() is True
    time.sleep(0.4)
    assert w.trips == 0 and w.disarm() is not None
    # a step finishing while the fire is in its dump gets nothing delivered
    monkeypatch.setattr(twd, "dump_all_stacks", lambda *a, **k: time.sleep(0.4))
    w2 = twd.StepWatchdog(min_timeout=0.1, startup_timeout=0.1)
    w2.arm()
    time.sleep(0.25)
    assert w2.disarm() is None
    time.sleep(0.5)
    for _ in range(1000):
        pass
    assert w2.trips == 1
    w.close()
    w2.close()


def test_touch_heartbeat_and_config_dump_path(tmp_path):
    p = str(tmp_path / "nested" / "hb")
    assert twd.touch_heartbeat(p) is True
    m1 = os.stat(p).st_mtime_ns
    time.sleep(0.02)
    assert twd.touch_heartbeat(p) and os.stat(p).st_mtime_ns > m1
    twd.set_default_dump_path("/tmp/x", source="config")
    twd.clear_config_dump_path()
    assert twd._default_dump_path is None
    twd.set_default_dump_path("/tmp/y")
    twd.clear_config_dump_path()
    assert twd._default_dump_path == "/tmp/y"
    twd.set_default_dump_path(None)


# --------------------------------------------------------- in the engine
def _engine(watchdog=None, extra=None):
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import simple

    cfg = {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "steps_per_print": 0, **({"watchdog": watchdog} if watchdog else {}), **(extra or {})}
    model = simple.SimpleModel(16, 2).init_params(torch.Generator().manual_seed(0))
    return deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")[0]


def _xy():
    rng = np.random.RandomState(0)
    return rng.randn(8, 16).astype(np.float32), rng.randn(8, 16).astype(np.float32)


def test_engine_watchdog_learns_step_times_and_touches_the_heartbeat(tmp_path, monkeypatch):
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.resilience import consistency

    calls = []
    real = consistency.check_step_agreement
    monkeypatch.setattr(consistency, "check_step_agreement",
                        lambda step, loss, rng=None, extra=b"":
                        calls.append(step) or real(step, loss, rng=rng, extra=extra))
    hb = tmp_path / "hb" / "heartbeat"
    engine = _engine({"enabled": True, "min_step_timeout": 30.0, "heartbeat_file": str(hb),
                      "consistency_interval": 2, "barrier_timeout": 77.0})
    mtimes = []
    for _ in range(4):
        engine.train_batch(_xy())
        mtimes.append(os.stat(hb).st_mtime_ns)
        time.sleep(0.01)
    assert len(engine._watchdog._durations) == 4 and engine._watchdog.deadline_s() == 30.0
    assert all(b > a for a, b in zip(mtimes, mtimes[1:])) and calls == [2, 4]
    assert comm._default_barrier_timeout == 77.0
    engine._watchdog.close()
    # the launcher's variable when the block names no file
    monkeypatch.setenv("DS_TPU_HEARTBEAT_FILE", str(tmp_path / "env_hb"))
    engine = _engine({"enabled": True, "min_step_timeout": 30.0})
    engine.train_batch(_xy())
    assert (tmp_path / "env_hb").exists()
    engine._watchdog.close()
    # a later engine without the block drops the config's barrier default
    # and dump file, not a manual one
    _engine()
    assert comm._default_barrier_timeout is None
    comm.set_default_barrier_timeout(7.0)
    twd.set_default_dump_path("/tmp/manual-dump.txt")
    _engine()
    assert comm._default_barrier_timeout == 7.0
    assert twd._default_dump_path == "/tmp/manual-dump.txt"
    comm.set_default_barrier_timeout(None)
    twd.set_default_dump_path(None)


def test_engine_hang_and_wedged_iterator_end_in_clean_timeouts(tmp_path):
    """A chaos hang on the train_step hook and a wedged data iterator,
    inside the armed region: a WatchdogTimeout each, the dump in
    ``stack_dump_file``; both stop before any launch, so the engine trains
    on afterwards."""
    dump = tmp_path / "stacks.txt"
    engine = _engine({"enabled": True, "min_step_timeout": 1.0, "startup_timeout": 60.0,
                      "stack_dump_file": str(dump)})
    engine.train_batch(_xy())
    tchaos.install_chaos(tchaos.ChaosInjector(hang_at={"train_step": [1]}, hang_s=60.0))
    t0 = time.monotonic()
    with pytest.raises(twd.WatchdogTimeout):
        engine.train_batch(_xy())
    assert time.monotonic() - t0 < 10.0 and "watchdog stack dump" in dump.read_text()
    tchaos.uninstall_chaos()

    def wedged():
        yield _xy()
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:       # an interruptible stall
            time.sleep(0.02)
        yield _xy()

    it = wedged()
    engine.train_batch(data_iter=it)
    t0 = time.monotonic()
    with pytest.raises(twd.WatchdogTimeout):
        engine.train_batch(data_iter=it)
    assert time.monotonic() - t0 < 10.0 and engine._watchdog.trips == 2
    assert np.isfinite(float(engine.train_batch(_xy())))
    engine._watchdog.close()
