"""Each producer of flight-recorder events in the port against its JAX
counterpart, on the CPU.

With a recorder armed in each package, the same trigger goes through the
JAX producer and the port's: an overrun of ``run_with_deadline`` (the
watchdog's timeout), a chaos injection, a rewind recovery, an elastic
agent's restart after a failed step, and the serving front-end's breaker
tripping open over a queued request (the breaker transition, the serving
transition, the shed of the admitted request, and a shed at the door).
Each producer's events have the JAX kind, severity, payload and step.
"""

import time
import types

import numpy as np
import pytest

from deepspeed_tpu import blackbox as jbb
from deepspeed_tpu.runtime.config import BlackboxConfig as JBlackboxConfig
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu_torch import blackbox as tbb
from deepspeed_tpu_torch.runtime.config import BlackboxConfig as TBlackboxConfig
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig

PACKAGES = {"jax": "deepspeed_tpu", "torch": "deepspeed_tpu_torch"}


@pytest.fixture(autouse=True)
def _teardown():
    yield
    jbb.deconfigure()
    tbb.deconfigure()
    import deepspeed_tpu.resilience.chaos as jchaos
    import deepspeed_tpu_torch.resilience.chaos as tchaos

    jchaos.uninstall_chaos()
    tchaos.uninstall_chaos()


def _mod(side, name):
    import importlib

    return importlib.import_module(f"{PACKAGES[side]}.{name}")


def _watchdog(side):
    wd = _mod(side, "resilience.watchdog")
    with pytest.raises(wd.WatchdogTimeout):
        wd.run_with_deadline(lambda: time.sleep(0.5), timeout=0.05, name="probe",
                             dump_path=None)


def _chaos(side):
    chaos = _mod(side, "resilience.chaos")
    inj = chaos.ChaosInjector(delay_at={"train_step": [1]}, fail_at={"train_step": [2]},
                              max_delay_s=0.001)
    inj.before("train_step", "step=1")
    with pytest.raises(chaos.ChaosError):
        inj.before("train_step", "step=2")


def _rewind(side):
    rewind = _mod(side, "resilience.rewind")
    rewind.RewindManager.note_recovery(types.SimpleNamespace(), {
        "tier": "ram", "snapshot_step": 4, "steps_lost": None, "restore_s": 0.0123})


class _StubEngine:
    """What the elastic agent reads of an engine; the first step of the
    first engine fails."""
    failed = []

    def __init__(self):
        self.state = types.SimpleNamespace(step=0)
        self._last_recovery = None
        self._watchdog = None

    @property
    def global_steps(self):
        return self.state.step

    def train_batch(self, batch):
        if not self.failed:
            self.failed.append(True)
            raise RuntimeError("boom")
        self.state.step += 1
        return 0.0

    def save_checkpoint(self, *args, **kwargs):
        pass


def _restart(side, tmp_path):
    agent_mod = _mod(side, "elasticity.elastic_agent")
    retry = _mod(side, "resilience.retry")
    _StubEngine.failed = []
    agent = agent_mod.DSElasticAgent(
        _StubEngine, str(tmp_path / f"ckpt_{side}"), checkpoint_interval=0, max_restarts=1,
        install_signal_handlers=False,
        restart_backoff=retry.RestartBackoff(base_delay=0.0, jitter=0.0))
    out = agent.run([None, None], num_steps=2)
    assert out["status"] == "complete" and out["restarts"] == 1


def _serving(side):
    """The breaker trips open over one queued request of a front-end that
    was never started; then a submit is shed at the door."""
    serving = _mod(side, "serving")
    Config = JConfig if side == "jax" else TConfig
    engine = types.SimpleNamespace(_config=types.SimpleNamespace(max_out_tokens=64))
    fe = serving.ServingFrontEnd(engine, Config({"serving": {
        "max_queue_depth": 1, "breaker_threshold": 2, "breaker_cooldown_s": 600.0}}).serving,
        start=False)
    fe._transition(serving.ServerState.READY)
    fe.submit(np.zeros((1, 4), np.int32), max_new_tokens=2)
    with pytest.raises(serving.ShedError):
        fe.submit(np.zeros((1, 4), np.int32), max_new_tokens=2)       # queue full
    fe.breaker.record_failure()
    fe.breaker.record_failure()                                        # open
    with pytest.raises(serving.ShedError):
        fe.submit(np.zeros((1, 4), np.int32), max_new_tokens=2)       # circuit open


PRODUCERS = {
    "watchdog_timeout": (_watchdog, [("watchdog_timeout", "error",
                                      {"kind": "deadline", "stall_s": 0.05})]),
    "chaos_injection": (_chaos, [("chaos_injection", "warning",
                                  {"op": "train_step", "action": "delay"}),
                                 ("chaos_injection", "warning",
                                  {"op": "train_step", "action": "fail"})]),
    "rewind_recovery": (_rewind, [("rewind_recovery", "info",
                                   {"tier": "ram", "snapshot_step": 4, "restore_s": 0.0123})]),
    "restart": (_restart, [("restart", "error", {"restart": 1, "error": "RuntimeError: boom",
                                                 "backoff_s": 0.0})]),
    "breaker_transition": (_serving, [("breaker_transition", "error",
                                       {"from": "closed", "to": "open",
                                        "consecutive_failures": 2})]),
    "serving_transition": (_serving, [
        ("serving_transition", "info", {"from": "starting", "to": "ready", "reason": None}),
        ("serving_transition", "warning", {"from": "ready", "to": "degraded",
                                           "reason": None})]),
    "shed": (_serving, [("shed", "warning", {"reason": "queue_full"}),
                        ("shed", "warning", {"reason": "circuit_open"})]),
    "shed_admitted": (_serving, [("shed_admitted", "warning",
                                  {"reason": "circuit_open", "retry_after_s": 600.0})]),
}


@pytest.mark.parametrize("producer", sorted(PRODUCERS))
def test_producer_event_equals_jax(tmp_path, producer):
    trigger, want = PRODUCERS[producer]
    got = {}
    for side, bb, Cfg in (("jax", jbb, JBlackboxConfig), ("torch", tbb, TBlackboxConfig)):
        rec = bb.configure(Cfg(output_dir=str(tmp_path / side), signal_snap=False))
        if trigger is _restart:
            trigger(side, tmp_path)
        else:
            trigger(side)
        got[side] = [(e["kind"], e["severity"], e["payload"], e["step"])
                     for e in rec.ring_snapshot() if e["kind"] == producer]
        errors = [e for e in rec.ring_snapshot() if e["severity"] == "error"]
        assert rec.bundles_written == (1 if errors else 0), side
        bb.deconfigure()
    assert got["torch"] == got["jax"]
    assert [e[:3] for e in got["torch"]] == want
    if producer == "restart":
        assert got["torch"][0][3] == 0                    # the failing step
    if producer == "rewind_recovery":
        assert got["torch"][0][3] == 4                    # the snapshot's step


def test_no_producer_imports_the_package():
    """Every producer reaches the recorder through ``sys.modules``."""
    import ast
    import pathlib

    port = pathlib.Path(__file__).resolve().parent.parent / "deepspeed_tpu_torch"
    for rel in ("resilience/watchdog.py", "resilience/chaos.py", "resilience/rewind.py",
                "elasticity/elastic_agent.py", "serving/frontend.py", "serving/breaker.py"):
        tree = ast.parse((port / rel).read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
                assert not any("blackbox" in n for n in names), rel
        assert 'sys.modules.get("deepspeed_tpu_torch.blackbox")' in (port / rel).read_text(), rel
