"""The flight recorder in the port's training engine and elastic agent, on
the CPU.

Without the ``blackbox`` block, or with ``enabled`` false, an engine's
``initialize`` and step never import ``deepspeed_tpu_torch.blackbox``.
Armed, a tiny GPT-2 trains to the same losses as unarmed, bit for bit; the
recorder sees every step, writes no bundle on a clean run, carries the
engine's config fingerprint and a world size of one process, writes its
bundles into the telemetry directory, and the incident report over them
names the first cause. A forced loss spike's ``sentinel_rewind`` error
(and the ``rewind_recovery`` that precedes it) equals the JAX engine's.
Under an elastic agent's installed SIGUSR1 handler one signal gives one
bundle whose stacks hold the main thread; three elastic restarts leave
one handler chain and no ``ds-blackbox-signal`` thread behind. A
``WatchdogTimeout`` delivered asynchronously while ``on_step`` holds the
ring lock leaves the lock released and the thread's held-lock entry
popped. Producers on more threads than cores lose no event, and their
concurrent errors write one bundle.
"""

import contextlib
import io
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.models import simple as tsimple
from deepspeed_tpu_torch.utils import locks

BB = "deepspeed_tpu_torch.blackbox"
HIDDEN, TBS = 16, 8
SMALL_GPT2 = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2, n_head=2, remat=False,
                  use_flash_attention=False)
SENTINEL = {"resilience": {"sentinel": {"enabled": True, "patience": 2}},
            "rewind": {"ram_interval": 1, "keep": 2}}


@pytest.fixture(autouse=True)
def _teardown():
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT, signal.SIGUSR1)}
    yield
    bb = sys.modules.get(BB)
    if bb is not None:
        bb.deconfigure()
    ttel.deconfigure()
    from deepspeed_tpu_torch.resilience import chaos, rewind

    chaos.uninstall_chaos()
    rewind.clear_ram_snapshots()
    for s, h in handlers.items():
        signal.signal(s, h)


def _config(**extra):
    return {"train_batch_size": TBS, "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
            "steps_per_print": 0, **extra}


def _simple_engine(**extra):
    model = tsimple.SimpleModel(HIDDEN, 2).init_params(torch.Generator().manual_seed(0))
    return deepspeed_tpu_torch.initialize(model=model, config=_config(**extra), device="cpu")[0]


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(TBS, HIDDEN).astype(np.float32), rng.randn(TBS, 1).astype(np.float32))


@contextlib.contextmanager
def _without_blackbox():
    saved = {m: sys.modules.pop(m) for m in list(sys.modules) if m == BB or m.startswith(BB + ".")}
    try:
        yield
    finally:
        sys.modules.update(saved)


@pytest.mark.parametrize("block", [None, {"enabled": False}], ids=["absent", "disabled"])
def test_strict_noop_never_imports(block):
    with _without_blackbox():
        engine = _simple_engine(**({} if block is None else {"blackbox": block}))
        engine.train_batch(_batch())
        assert engine._blackbox is None
        assert BB not in sys.modules


def _gpt2_losses(tmp_path, extra):
    from deepspeed_tpu_torch.models import gpt2 as tgpt2

    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL_GPT2, dtype=torch.float32)).init_params(
        torch.Generator().manual_seed(0))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, device="cpu", config={
        "train_batch_size": 8, "steps_per_print": 0,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, **extra})
    ids = np.random.RandomState(1).randint(0, SMALL_GPT2["vocab_size"], size=(8, 32))
    return engine, [float(engine.train_batch({"input_ids": ids})) for _ in range(3)]


def test_armed_gpt2_losses_equal_unarmed_bit_for_bit(tmp_path):
    from deepspeed_tpu_torch.resilience.consistency import config_fingerprint

    _, plain = _gpt2_losses(tmp_path, {})
    engine, armed = _gpt2_losses(tmp_path, {"blackbox": {"output_dir": str(tmp_path / "bb"),
                                                         "signal_snap": False}})
    assert armed == plain
    rec = engine._blackbox
    assert rec.steps_seen() == 3 and rec.last_step == 3 and rec.overhead_us() > 0.0
    assert [t["step"] for t in rec.step_tail_snapshot()] == [1, 2, 3]
    assert all(t["wall_s"] is None for t in rec.step_tail_snapshot())
    assert rec.bundles_written == 0 and not os.path.exists(tmp_path / "bb" / "incidents")
    assert rec.world_size == 1
    assert rec.config_fingerprint == config_fingerprint(
        engine._config.to_dict(), mesh={"data": 1, "expert": 1})


def test_watchdog_fingerprint_is_the_startup_hash(tmp_path):
    engine = _simple_engine(watchdog={"enabled": True},
                            blackbox={"output_dir": str(tmp_path), "signal_snap": False})
    assert engine._blackbox.config_fingerprint == engine._config_fingerprint
    engine._watchdog.close()


def test_engine_bundles_land_in_telemetry_and_report_names_cause(tmp_path):
    from deepspeed_tpu_torch import blackbox
    from deepspeed_tpu_torch.blackbox import incident

    tel = str(tmp_path / "tel")
    engine = _simple_engine(blackbox={"signal_snap": False}, telemetry={
        "enabled": True, "output_dir": tel, "prometheus": False, "flush_interval": 1})
    for i in range(3):
        engine.train_batch(_batch(i))
    rec = engine._blackbox
    assert rec.output_dir() == tel and rec.steps_seen() == 3
    blackbox.record("gray_verdict", "error", {"device": 3, "kind": "slow-compute"}, step=3)
    assert rec.bundles_written == 1
    names = os.listdir(rec.last_bundle_dir)
    assert "metrics_tail.jsonl" in names and "trace_tail.jsonl" in names
    with open(os.path.join(rec.last_bundle_dir, "metrics_tail.jsonl")) as f:
        assert "train/loss" in f.read()
    ttel.flush()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert incident.main(["report", tel]) == 0
    assert "first cause: rank 0 device 3" in out.getvalue()
    assert "missing bundle" not in out.getvalue()


def test_sentinel_rewind_event_equals_jax_engine(tmp_path):
    import deepspeed_tpu
    from deepspeed_tpu import blackbox as jbb
    from deepspeed_tpu.comm import comm as jcomm
    from deepspeed_tpu.models import simple as jsimple
    from deepspeed_tpu.resilience import rewind as jrewind
    from deepspeed_tpu.runtime.config import BlackboxConfig as JBlackboxConfig
    from deepspeed_tpu_torch import blackbox as tbb
    from deepspeed_tpu_torch.runtime.config import BlackboxConfig as TBlackboxConfig

    got = {}
    try:
        for side, bb, Cfg in (("jax", jbb, JBlackboxConfig), ("torch", tbb, TBlackboxConfig)):
            rec = bb.configure(Cfg(output_dir=str(tmp_path / side), signal_snap=False,
                                   min_trigger_interval_s=0.0))
            if side == "jax":
                jcomm.cdb = None
                engine, *_ = deepspeed_tpu.initialize(
                    model=jsimple.SimpleModel(hidden_dim=HIDDEN, nlayers=2),
                    config=_config(**SENTINEL))
            else:
                engine = _simple_engine(**SENTINEL)
            for i in range(3):
                engine.train_batch(_batch(i))
            bad = _batch(9)
            bad[0][0, 0] = np.nan
            engine.train_batch(bad)
            engine.train_batch(bad)               # patience 2: the rewind
            got[side] = [(e["kind"], e["severity"], e["payload"], e["step"])
                         for e in rec.ring_snapshot()]
            assert rec.bundles_written == 1
    finally:
        jbb.deconfigure()
        jrewind.clear_ram_snapshots()
    timing = lambda evs: [(k, s, {n: v for n, v in p.items() if n != "restore_s"}, st)  # noqa
                          for k, s, p, st in evs]
    assert timing(got["torch"]) == timing(got["jax"])
    assert [e[0] for e in got["torch"]] == ["rewind_recovery", "sentinel_rewind"]
    assert got["torch"][1][2] == {"reason": "non-finite loss (nan)", "tier": "ram", "rewind": 1,
                                  "max_rewinds": 2}


class _StubEngine:
    global_steps = 0
    _last_recovery = None
    _watchdog = None


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return pred()


def test_one_sigusr1_gives_one_bundle_under_elastic_agent(tmp_path):
    import faulthandler

    from deepspeed_tpu_torch import blackbox
    from deepspeed_tpu_torch.elasticity import DSElasticAgent
    from deepspeed_tpu_torch.runtime.config import BlackboxConfig

    DSElasticAgent(_StubEngine, str(tmp_path / "ckpt"), install_signal_handlers=True)
    try:
        rec = blackbox.configure(BlackboxConfig(output_dir=str(tmp_path)))
        os.kill(os.getpid(), signal.SIGUSR1)
        assert _wait(lambda: rec.bundles_written >= 1)
        time.sleep(0.6)                 # both handlers have run by now
        inc = tmp_path / "incidents"
        assert rec.bundles_written == 1 and len(os.listdir(inc)) == 1
        assert rec.last_trigger == "sigusr1"
        stacks = open(os.path.join(rec.last_bundle_dir, "stacks.txt")).read()
        assert os.path.basename(__file__) in stacks        # the main thread's frames
    finally:
        faulthandler.unregister(signal.SIGUSR1)


def test_three_elastic_restarts_leave_one_handler_chain(tmp_path):
    import faulthandler

    from deepspeed_tpu_torch.elasticity import DSElasticAgent
    from deepspeed_tpu_torch.resilience import chaos
    from deepspeed_tpu_torch.resilience.retry import RestartBackoff

    recorders = []

    def factory():
        engine = _simple_engine(blackbox={"output_dir": str(tmp_path / "bb")})
        recorders.append(engine._blackbox)
        return engine

    chaos.install_chaos(chaos.ChaosInjector(fail_at={"train_step": [2, 4, 6]}))
    agent = DSElasticAgent(factory, str(tmp_path / "ckpt"), checkpoint_interval=0,
                           max_restarts=3, install_signal_handlers=True,
                           restart_backoff=RestartBackoff(base_delay=0.0, jitter=0.0))
    try:
        agent_handler = signal.getsignal(signal.SIGUSR1)
        out = agent.run(lambda: iter(lambda: _batch(), None), num_steps=3)
        assert out["status"] == "complete" and out["restarts"] == 3
        live = recorders[-1]
        assert len(recorders) == 4 and all(r._closed for r in recorders[:-1])
        assert signal.getsignal(signal.SIGUSR1) is not agent_handler
        assert live._prev_sigusr1 is agent_handler
        threads = [t for t in threading.enumerate() if t.name == "ds-blackbox-signal"]
        assert threads == [live._signal_thread]
        from deepspeed_tpu_torch import blackbox

        blackbox.deconfigure()
        assert signal.getsignal(signal.SIGUSR1) is agent_handler
        assert locks.leaked_threads(timeout=3.0, owner="blackbox") == []
        restarts = [e for r in recorders for e in r.ring_snapshot() if e["kind"] == "restart"]
        assert [e["payload"]["restart"] for e in restarts] == [1, 2, 3]
    finally:
        faulthandler.unregister(signal.SIGUSR1)


def test_async_timeout_inside_on_step_releases_ring_lock(tmp_path):
    from deepspeed_tpu_torch import blackbox
    from deepspeed_tpu_torch.resilience import watchdog
    from deepspeed_tpu_torch.runtime.config import BlackboxConfig

    rec = blackbox.configure(BlackboxConfig(output_dir=str(tmp_path), signal_snap=False))
    inside, seen = threading.Event(), {}

    class SpinningTail(list):
        def append(self, item):         # runs under the ring lock
            inside.set()
            while True:
                time.sleep(0.005)

    rec._step_tail = SpinningTail()

    def worker():
        try:
            rec.on_step(1)
        except watchdog.WatchdogTimeout as e:
            seen["error"] = str(e)
        seen["held"] = [name for name, _ in locks._held_stack()]

    t = threading.Thread(target=worker)
    t.start()
    assert inside.wait(5.0)
    assert watchdog._async_raise(t.ident, "step deadline")
    t.join(5.0)
    assert not t.is_alive() and seen["error"] == "step deadline"
    assert "blackbox.ring" not in seen["held"]
    assert rec._lock._holder is None
    assert "blackbox.ring" not in locks.format_lock_holders()
    other = threading.Thread(target=rec.record, args=("shed", "warning", {}))
    other.start()
    other.join(2.0)
    assert not other.is_alive() and rec.events_total == 1


def test_concurrent_producers_lose_no_event_and_race_for_one_bundle(tmp_path):
    """More producer threads than cores, with a tiny switch interval: every
    event counted once, the ring bounded, and the rate limit's slot claimed
    under the lock so the error storm writes one bundle."""
    from deepspeed_tpu_torch import blackbox
    from deepspeed_tpu_torch.runtime.config import BlackboxConfig

    rec = blackbox.configure(BlackboxConfig(output_dir=str(tmp_path), signal_snap=False,
                                            ring_size=64, min_trigger_interval_s=3600.0))
    n_threads, per_thread = (os.cpu_count() or 1) + 4, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def produce(i):
            for j in range(per_thread):
                rec.record("stress", "error" if j % 50 == 0 else "info", {"t": i, "j": j})
                rec.on_step(j)

        threads = [threading.Thread(target=produce, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert rec.events_total == n_threads * per_thread
    assert rec.errors_total == n_threads * (per_thread // 50)
    assert rec.steps_seen() == n_threads * per_thread
    assert len(rec.ring_snapshot()) == 64
    assert rec.bundles_written == 1 and len(os.listdir(tmp_path / "incidents")) == 1
