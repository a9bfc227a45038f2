"""The port's ``run_with_deadline``, chaos injector and lock factory
against the JAX package's, on the CPU.

``run_with_deadline`` returns the value, re-raises the call's error, turns
an overrun into ``WatchdogTimeout`` with the ``watchdog_timeouts`` counter
and (unless ``stall_span=False``) a ``watchdog_stall`` span, and refuses a
non-positive timeout, as in JAX. The chaos injector, given the same seed
and script, fires the same fail / hang / delay sequence as JAX's (one
``random.Random(seed)`` stream drawn in the same order) with the same
counts; the fault classes of several devices and the ``collective`` hook
raise in the constructor, and the others are taken as JAX takes them. Threads spawned through the lock factory are registered and
joined, and the named locks witness their order.
"""

import threading
import time

import pytest

from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.resilience import chaos as jchaos
from deepspeed_tpu.resilience import watchdog as jwd
from deepspeed_tpu.runtime.config import TelemetryConfig as JTelemetryConfig
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.resilience import chaos as tchaos
from deepspeed_tpu_torch.resilience import watchdog as twd
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.config import TelemetryConfig as TTelemetryConfig
from deepspeed_tpu_torch.utils import locks

SIDES = (("jax", jwd, jtel, JTelemetryConfig), ("torch", twd, ttel, TTelemetryConfig))


@pytest.fixture(autouse=True)
def _clean():
    yield
    jtel.deconfigure()
    ttel.deconfigure()
    jchaos.uninstall_chaos()
    tchaos.uninstall_chaos()


def _series(tel):
    reg = {(r["name"], tuple(sorted(r["labels"].items()))): r.get("value")
           for r in tel.get_registry().snapshot()}
    spans = [(e["name"], e["ph"], e["cat"], e["args"]) for e in tel.get_tracer().events]
    return reg, spans


def test_run_with_deadline_as_in_jax(tmp_path, capsys):
    got = {}
    for side, wd, tel, Cfg in SIDES:
        tel.configure(Cfg(enabled=True, output_dir=str(tmp_path / side)))
        assert wd.run_with_deadline(lambda: 41 + 1, timeout=5.0, name="value") == 42
        with pytest.raises(KeyError, match="boom"):
            wd.run_with_deadline(lambda: {}["boom"], timeout=5.0, name="error")
        for bad in (0, -1.0, None):
            with pytest.raises(ValueError, match="timeout must be positive"):
                wd.run_with_deadline(lambda: None, timeout=bad, name="bad")
        t0 = time.monotonic()
        with pytest.raises(wd.WatchdogTimeout, match="stalled did not complete within 0.2s"):
            wd.run_with_deadline(lambda: time.sleep(0.6), timeout=0.2, name="stalled")
        assert time.monotonic() - t0 < 0.5
        with pytest.raises(wd.WatchdogTimeout):
            wd.run_with_deadline(lambda: time.sleep(0.6), timeout=0.2, name="budget",
                                 stall_span=False, dump_path=str(tmp_path / f"{side}.dump"),
                                 on_timeout_info=lambda: " (2 ranks missing)")
        reg, spans = _series(tel)
        # the stall span's duration is the timeout: in microseconds
        stall = [e for e in tel.get_tracer().events if e["name"] == "watchdog_stall"]
        assert [e["dur"] for e in stall] == [pytest.approx(0.2e6)]
        got[side] = (reg, spans)
        assert "watchdog stack dump" in (tmp_path / f"{side}.dump").read_text()
        tel.deconfigure()
    assert got["torch"] == got["jax"]
    reg, spans = got["torch"]
    assert reg[("resilience/watchdog_timeouts", (("kind", "deadline"),))] == 2.0
    assert [s[0] for s in spans] == ["watchdog_timeout", "watchdog_stall", "watchdog_timeout"]
    # the dump names every thread's stack and the locks' holders on stderr
    assert "lock holders:" in capsys.readouterr().err
    time.sleep(0.5)             # the disowned sleepers finish


def test_default_dump_path_takes_a_dump_without_its_own(tmp_path, capsys):
    dump = tmp_path / "stacks.txt"
    twd.set_default_dump_path(str(dump))
    try:
        with pytest.raises(twd.WatchdogTimeout):
            twd.run_with_deadline(lambda: time.sleep(0.4), timeout=0.1, name="defaulted")
    finally:
        twd.set_default_dump_path(None)
    text = dump.read_text()
    assert "watchdog stack dump (watchdog: defaulted" in text and "Thread MainThread" in text
    assert "ds-deadline-defaulted" in text          # the disowned worker, mid-sleep
    capsys.readouterr()
    time.sleep(0.4)


SCRIPT = dict(seed=7, failure_rate=0.25, delay_rate=0.3, hang_rate=0.2, hang_s=0.0,
              max_delay_s=0.001, ops=["decode_step"], fail_at={"decode_step": [3, 9]},
              hang_at={"decode_step": [5]}, delay_at={"decode_step": [6, 7]})


@pytest.mark.parametrize("seed", [7, 11])
def test_chaos_sequence_and_counts_equal_jax(tmp_path, seed):
    got = {}
    for side, chaos, tel, Cfg in (("jax", jchaos, jtel, JTelemetryConfig),
                                  ("torch", tchaos, ttel, TTelemetryConfig)):
        tel.configure(Cfg(enabled=True, output_dir=str(tmp_path / side)))
        inj = chaos.ChaosInjector(**{**SCRIPT, "seed": seed})
        fired = []
        for i in range(40):
            try:
                inj.before("decode_step", f"req-{i}")
                fired.append("ok")
            except chaos.ChaosError as e:
                fired.append(str(e))
        assert inj.targets("decode_step")
        got[side] = (fired, [(op, act if not act.startswith("delay") else act[:5], p)
                             for op, act, p in inj.log],
                     dict(inj._counts), _series(tel)[0])
        tel.deconfigure()
    assert got["torch"] == got["jax"]
    fired, log, counts, reg = got["torch"]
    assert counts == {"decode_step": 40}
    assert {a for _, a, _ in log} == {"fail", "hang 0.0s", "delay"}
    assert reg[("resilience/chaos_injections", (("action", "fail"), ("op", "decode_step")))] \
        == sum(1 for f in fired if f != "ok")


def test_chaos_from_env_and_active_injector(monkeypatch):
    spec = "seed=3,hang_rate=0.5,hang_s=0,ops=decode_step"
    j, t = jchaos.ChaosInjector.from_env(spec), tchaos.ChaosInjector.from_env(spec)
    assert (t.seed, t.hang_rate, t.hang_s, t.ops) == (j.seed, j.hang_rate, j.hang_s, j.ops)
    monkeypatch.setattr(tchaos, "_env_checked", False)
    monkeypatch.setattr(tchaos, "_installed", None)
    monkeypatch.setenv("DS_CHAOS", spec)
    inj = tchaos.active_injector()
    assert inj is not None and inj.source == "env" and tchaos.active_injector() is inj
    tchaos.uninstall_chaos()
    assert tchaos.active_injector() is None       # an explicit uninstall wins over the env


# the fault classes of several devices and the collective hook: a later slice
REFUSED = {
    "shrink_at": dict(shrink_at={"train_step": [2]}, shrink_to=6),
    "grow_to": dict(grow_to=8),
    "bitflip_at": dict(bitflip_at=6, bitflip_rate=1.0),
    "slow_device": dict(slow_from_step=11, slow_rate=0.0),
    "collective_mismatch": dict(collective_mismatch=True),
    "collective_hook": dict(ops=["collective"], delay_rate=0.5),
    "collective_scripted": dict(hang_at={"collective": [1]}),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_later_fault_classes_and_hooks_raise(name):
    with pytest.raises(NotImplementedError, match="later slice"):
        tchaos.ChaosInjector(**REFUSED[name])


# the fault classes and hooks a card's training run reaches, taken as the
# JAX injector takes them (their sequences: test_torch_resilience_units.py)
ACCEPTED = {
    "truncate_rate": dict(truncate_rate=0.1),
    "truncate_at": dict(truncate_at={"decode_step": [1]}),
    "kill_at": dict(kill_at={"decode_step": [1]}),
    "preempt_at": dict(preempt_at={"decode_step": [1]}),
    "preempt_rate": dict(preempt_rate=0.1, ops=["decode_step"]),
    "checkpoint_io_hook": dict(fail_at={"latest": [1]}),
    "train_step_hook": dict(hang_at={"train_step": [1]}),
    "rate_without_ops": dict(failure_rate=0.2),
}


@pytest.mark.parametrize("name", sorted(ACCEPTED))
def test_fault_classes_and_hooks_of_a_training_run_accepted(name):
    t = tchaos.ChaosInjector(**ACCEPTED[name])
    j = jchaos.ChaosInjector(**ACCEPTED[name])
    for op in ("decode_step", "train_step", "latest", "state_save"):
        assert t.targets(op) == j.targets(op), op


def test_chaos_config_block_still_raises():
    """An enabled chaos block installs the injector and the watchdog block
    parses now; the chaos knobs of several devices still raise."""
    assert DeepSpeedConfig({"resilience": {"chaos": {"enabled": True}}}).resilience.chaos.enabled
    assert DeepSpeedConfig({"watchdog": {"enabled": True}}).watchdog.enabled
    with pytest.raises(NotImplementedError, match="chaos"):
        DeepSpeedConfig({"resilience": {"chaos": {"enabled": True,
                                                  "collective_mismatch": True}}})


def test_retry_and_verify_counters_as_in_jax(tmp_path):
    """The checkpoint I/O's retries and give-ups and a failed tag
    verification land in the same series as JAX's."""
    import importlib

    # the modules, not the packages' re-exported ``retry`` function
    jretry, jmanifest, tretry, tmanifest = (
        importlib.import_module(f"{pkg}.resilience.{mod}")
        for pkg in ("deepspeed_tpu", "deepspeed_tpu_torch") for mod in ("retry", "manifest"))

    got = {}
    for side, retry, manifest, tel, Cfg in (
            ("jax", jretry, jmanifest, jtel, JTelemetryConfig),
            ("torch", tretry, tmanifest, ttel, TTelemetryConfig)):
        tel.configure(Cfg(enabled=True, output_dir=str(tmp_path / side)))
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("flaky disk")
            return "ok"

        policy = retry.RetryPolicy(max_attempts=4, base_delay=0.0, jitter=0.0, seed=0)
        assert retry.retry(flaky, policy, op="latest", sleep=lambda d: None) == "ok"
        with pytest.raises(OSError):
            retry.retry(lambda: open(tmp_path / "missing" / "x"), policy, op="manifest",
                        sleep=lambda d: None)
        assert manifest.verify_tag(str(tmp_path / "no_such_tag"))[0] is False
        got[side] = _series(tel)[0]
        tel.deconfigure()
    assert got["torch"] == got["jax"]
    assert got["torch"][("resilience/retries", (("op", "latest"),))] == 2.0
    assert got["torch"][("resilience/retries", (("op", "manifest"),))] == 3.0
    assert got["torch"][("resilience/retry_exhausted", (("op", "manifest"),))] == 1.0
    assert got["torch"][("resilience/verify_failures", ())] == 1.0


def test_lock_factory_threads_registered_and_joined():
    release = threading.Event()
    t = locks.spawn_thread(release.wait, name="ds-test-waiter", owner="test-owner",
                           args=(10.0,))
    assert not t.is_alive()              # built, not started
    t.start()
    rec = [r for r in locks.framework_threads() if r.thread is t]
    assert rec and rec[0].owner == "test-owner" and rec[0].expect_join and rec[0].daemon
    assert [r.thread for r in locks.leaked_threads(timeout=0.05, owner="test-owner")] == [t]
    release.set()
    assert locks.leaked_threads(timeout=5.0, owner="test-owner") == []
    # a disowned thread (expect_join=False) is never a leak
    stuck = locks.spawn_thread(time.sleep, name="ds-test-disowned", owner="test-owner",
                               expect_join=False, args=(0.3,))
    stuck.start()
    assert locks.leaked_threads(timeout=0.01, owner="test-owner") == []
    stuck.join()


def test_named_locks_witness_and_holders():
    a, b = locks.make_lock("test.a"), locks.make_rlock("test.b")
    cond = locks.make_condition("test.b", b)
    locks.enable_witness(reset=True)
    try:
        with a:
            with b:
                with b:                      # reentrant: no self edge
                    assert any(h["lock"] == "test.a" for h in locks.current_lock_holders())
        with cond:
            assert not cond.wait(0.01)
    finally:
        locks.disable_witness()
    edges = {(e["src"], e["dst"]) for e in locks.witness_edges()}
    assert edges == {("test.a", "test.b")}
    assert "lock holders: none" in locks.format_lock_holders()
    with pytest.raises(ValueError):
        locks.signal_safe("")


def test_frontend_threads_are_the_lock_factorys():
    """The serving worker is a registered ``serving`` thread, joined by
    ``close()``; its ticks are disowned ``watchdog`` threads."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.serving import ServingFrontEnd

    eng = deepspeed_tpu_torch.init_inference(
        gpt2.GPT2Model(gpt2.GPT2Config(vocab_size=64, n_positions=32, n_embd=32, n_layer=1,
                                       n_head=2, dtype=torch.float32)),
        {"dtype": "float32", "max_out_tokens": 16}, device="cpu")
    fe = ServingFrontEnd(eng, DeepSpeedConfig({"serving": {"max_queue_depth": 2,
                                                           "decode_tick_tokens": 2}}).serving)
    r = fe.submit(np.arange(4)[None], max_new_tokens=4).result(timeout=60)
    assert r.status == "completed"
    live = {rec.name: rec for rec in locks.live_framework_threads(owner="serving")}
    assert "ds-serve-worker" in live
    ticks = [rec for rec in locks.framework_threads() if rec.owner == "watchdog"
             and rec.name.startswith("ds-deadline-serve-tick")]
    assert ticks and not any(rec.expect_join for rec in ticks)
    fe.close()
    assert locks.leaked_threads(timeout=5.0, owner="serving") == []
