"""The port's serving front-end through the JAX package's failure drills.

The drills of ``tests/unit/test_serving.py`` (admission through drain),
with their assertions, on the port's front-end over a tiny GPT-2 on the
CPU (vocab 256, n_embd 64, 2 layers, 4 heads, fp32, ``max_out_tokens``
64, ticks of 4), with the port's chaos injector on the ``decode_step``
hook: the half-open probe slot handed back when the probe expires in the
queue, a request deadline capping the decode, a hung tick timed out while
the server keeps serving (and the next request's tokens still equal
``generate``'s: the disowned tick wrote nothing of it), the circuit opening,
shedding and closing through a probe, a failed probe re-opening it, a
drain flushing partials with exit code 87, an agent's preemption flag
draining, and the many-client drill where every admitted request resolves.
One engine and one loop cache serve the whole file; hangs, cooldowns and
tick caps are short, as in the JAX drills.
"""

import threading
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.launcher.launch import DRAIN_EXIT_CODE, HEARTBEAT_KILL_EXIT_CODE
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.resilience.chaos import ChaosInjector, install_chaos, uninstall_chaos
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.serving import ServingFrontEnd, ShedError

CHUNK = 4
_PROGRAMS: dict = {}
_WARM: dict = {}


@pytest.fixture(scope="module")
def engine():
    cfg = tgpt2.GPT2Config(vocab_size=256, n_positions=128, n_embd=64, n_layer=2, n_head=4,
                           dtype=torch.float32)
    eng = deepspeed_tpu_torch.init_inference(tgpt2.GPT2Model(cfg),
                                             {"dtype": "float32", "max_out_tokens": 64},
                                             device="cpu")
    # warm the greedy key's ticks once for the file (prompt length 8)
    fe = _frontend(eng)
    fe.submit(_prompt(), max_new_tokens=8).result(timeout=120)
    fe.close()
    return eng


@pytest.fixture(autouse=True)
def _chaos_clean():
    yield
    uninstall_chaos()


def _frontend(engine, start=True, agent=None, **serving):
    serving.setdefault("decode_tick_tokens", CHUNK)
    serving.setdefault("max_queue_depth", 8)
    ds = DeepSpeedConfig({"serving": serving})
    fe = ServingFrontEnd(engine, ds.serving, agent=agent, start=False)
    fe._programs = _PROGRAMS
    fe._warm = _WARM
    if start:
        fe.start()
    return fe


def _prompt(n=8, base=0):
    return (np.arange(base, base + n)[None, :] % 256).astype(np.int32)


def _rewarm(fe):
    """A greedy request after a dropped loop: the key's ticks are warm
    again (and its loop rebuilt) for the next drill step."""
    assert fe.submit(_prompt(), max_new_tokens=8).result(timeout=60).status == "completed"


def test_probe_slot_released_on_deadline_expiry(engine):
    install_chaos(ChaosInjector(fail_at={"decode_step": [1, 2]}))
    fe = _frontend(engine, breaker_threshold=2, breaker_cooldown_s=0.2)
    try:
        fe.submit(_prompt(), max_new_tokens=4).result(timeout=60)
        fe.submit(_prompt(), max_new_tokens=4).result(timeout=60)
        assert fe.breaker.state == "open"
        uninstall_chaos()
        time.sleep(0.25)
        # this probe claims the half-open slot, then expires in the queue
        # before its first tick
        p = fe.submit(np.zeros((1, 1), np.int32), max_new_tokens=1, deadline_s=1e-4,
                      is_probe=True)
        p.result(timeout=60)
        assert p.status == "shed" and p.reason == "deadline"
        # the slot came back: a real probe still half-opens → closes
        p2 = fe.probe(timeout=60)
        assert p2.status == "completed"
        assert fe.breaker.state == "closed"
    finally:
        fe.close()


def test_request_deadline_caps_decode(engine):
    # every tick pays a 0.25 s injected delay; a 0.9 s deadline dies
    # mid-decode with a partial and the reason on it
    install_chaos(ChaosInjector(delay_at={"decode_step": list(range(1, 40))},
                                max_delay_s=0.25))
    fe = _frontend(engine, decode_tick_timeout_s=30.0)
    try:
        r = fe.submit(_prompt(), max_new_tokens=40, deadline_s=0.9)
        r.result(timeout=60)
        assert r.status in ("partial", "shed")
        assert r.reason == "deadline"
        assert len(r.tokens) < 40
        assert fe.counts["timed_out"] == 1
        # a request deadline is not an engine failure
        assert fe.breaker.state == "closed"
    finally:
        fe.close()
    time.sleep(0.3)             # the disowned delayed tick ends


def test_hung_tick_times_out_and_server_survives(engine):
    fe = _frontend(engine, decode_tick_timeout_s=0.8)
    try:
        _rewarm(fe)
        install_chaos(ChaosInjector(hang_at={"decode_step": [2]}, hang_s=1.5))
        t0 = time.monotonic()
        r = fe.submit(_prompt(), max_new_tokens=8)
        r.result(timeout=60)
        # the hang became a clean sub-second timeout, not a wedge
        assert time.monotonic() - t0 < 1.4
        assert r.status in ("failed", "partial")
        assert r.reason == "timeout"
        uninstall_chaos()
        # the server keeps serving, and the request served while the
        # disowned tick is still asleep gets generate's tokens
        r2 = fe.submit(_prompt(base=3), max_new_tokens=8).result(timeout=60)
        assert r2.status == "completed"
        time.sleep(1.0)         # the disowned tick wakes, sees its flag, launches nothing
        r3 = fe.submit(_prompt(base=5), max_new_tokens=12).result(timeout=60)
        for req, base in ((r2, 3), (r3, 5)):
            ref = engine.generate(_prompt(base=base), max_new_tokens=len(req.tokens))
            assert req.tokens == ref[0, 8:].tolist()
    finally:
        fe.close()


def test_circuit_opens_sheds_and_recovers_via_probe(engine):
    install_chaos(ChaosInjector(fail_at={"decode_step": [1, 2]}))
    fe = _frontend(engine, breaker_threshold=2, breaker_cooldown_s=0.4)
    try:
        r1 = fe.submit(_prompt(), max_new_tokens=4).result(timeout=60)
        r2 = fe.submit(_prompt(), max_new_tokens=4).result(timeout=60)
        assert r1.status == "failed" and "ChaosError" in r1.reason
        assert r2.status == "failed"
        assert fe.breaker.state == "open"
        assert fe.state == "degraded"
        with pytest.raises(ShedError) as ei:
            fe.submit(_prompt(), max_new_tokens=4)
        assert ei.value.reason == "circuit_open"
        assert 0 < ei.value.retry_after_s <= 0.4
        uninstall_chaos()
        time.sleep(0.45)                   # the cooldown elapses
        p = fe.probe(timeout=60)
        assert p.status == "completed"
        assert fe.breaker.state == "closed"
        assert fe.state == "ready"
        t = fe.counts
        assert t["circuit_transitions{from=closed,to=open}"] == 1
        assert t["circuit_transitions{from=open,to=half_open}"] == 1
        assert t["circuit_transitions{from=half_open,to=closed}"] == 1
    finally:
        fe.close()


def test_failed_probe_reopens_circuit(engine):
    # ticks 1 and 2 fail the two requests that open the circuit; tick 3
    # fails the probe, which re-opens it
    install_chaos(ChaosInjector(fail_at={"decode_step": [1, 2, 3]}))
    fe = _frontend(engine, breaker_threshold=2, breaker_cooldown_s=0.3)
    try:
        fe.submit(_prompt(), max_new_tokens=4).result(timeout=60)
        fe.submit(_prompt(), max_new_tokens=4).result(timeout=60)
        assert fe.breaker.state == "open"
        time.sleep(0.35)
        p = fe.probe(timeout=60)
        assert p.status == "failed"
        assert fe.breaker.state == "open"
        assert fe.counts["circuit_transitions{from=half_open,to=open}"] == 1
    finally:
        fe.close()


def test_drain_mid_stream_flushes_partials(engine):
    assert DRAIN_EXIT_CODE != HEARTBEAT_KILL_EXIT_CODE != 0
    fe = _frontend(engine, drain_grace_s=0.8, decode_tick_timeout_s=30.0)
    try:
        _rewarm(fe)
        install_chaos(ChaosInjector(delay_at={"decode_step": list(range(1, 40))},
                                    max_delay_s=0.2))
        chunks = []
        r1 = fe.submit(_prompt(), max_new_tokens=40, deadline_s=60, stream=chunks.append)
        r2 = fe.submit(_prompt(base=8), max_new_tokens=4)   # queued behind
        time.sleep(0.7)                    # r1 is mid-stream
        fe.begin_drain("signal")
        code = fe.drain(timeout=30)
        r1.result(timeout=5)
        r2.result(timeout=5)
        # in flight: finished or capped, its partial flushed
        assert r1.status in ("partial", "completed")
        if r1.status == "partial":
            assert r1.reason == "drained"
        assert chunks, "the streaming consumer never saw the partial"
        assert [t for c in chunks for t in c] == r1.tokens[:sum(len(c) for c in chunks)]
        # queued: a structured shed with the back-off hint, counted on the
        # admitted side of the ledger
        assert r2.status == "shed" and r2.reason == "draining"
        assert r2.retry_after_s > 0
        assert r2.to_dict()["retry_after_s"] == r2.retry_after_s
        assert fe.counts["shed_admitted{reason=draining}"] == 1
        assert code == DRAIN_EXIT_CODE
        assert fe.state == "dead"
        with pytest.raises(ShedError):
            fe.submit(_prompt(), max_new_tokens=4)
    finally:
        fe.close()
    time.sleep(0.25)


def test_agent_preemption_flag_triggers_drain(engine, tmp_path):
    from deepspeed_tpu_torch.elasticity import DSElasticAgent

    agent = DSElasticAgent(lambda: None, str(tmp_path), install_signal_handlers=False)
    fe = _frontend(engine, agent=agent)
    try:
        r = fe.submit(_prompt(), max_new_tokens=4)
        r.result(timeout=60)
        assert not agent.preempted
        agent.preempt()
        code = fe.drain(timeout=30)
        assert fe.state == "dead"
        assert code == DRAIN_EXIT_CODE
        assert fe.counts["state_transitions{from=ready,to=draining}"] == 1
    finally:
        fe.close()


def test_many_clients_zero_silent_drops(engine):
    """Concurrent clients, an injected failed tick and a hung tick, a drain
    mid-flight: every admitted request resolves to tokens, a partial with a
    reason or a structured shed, and the ledger adds up."""
    fe = _frontend(engine, max_queue_depth=4, breaker_threshold=3,
                   decode_tick_timeout_s=0.8, drain_grace_s=1.0)
    _rewarm(fe)
    install_chaos(ChaosInjector(fail_at={"decode_step": [4]}, hang_at={"decode_step": [7]},
                                hang_s=1.5))
    results, sheds, lock = [], [], threading.Lock()

    def client(i):
        try:
            r = fe.submit(_prompt(base=i), max_new_tokens=8, deadline_s=120)
            r.result(timeout=120)
            with lock:
                results.append(r)
        except ShedError as e:
            with lock:
                sheds.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    try:
        for t in threads[:6]:
            t.start()
        time.sleep(1.0)
        fe.begin_drain("signal")
        for t in threads[6:]:
            t.start()                       # submitted after the drain began
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads), "a client wedged"
        assert len(results) + len(sheds) == 8
        for r in results:
            assert r.status in ("completed", "partial", "shed", "failed"), r
            if r.status != "completed":
                assert r.reason, f"terminal without a reason: {r}"
        fe.drain(timeout=30)
        assert fe.state == "dead"
        c = fe.counts
        admitted = c.get("admitted", 0)
        resolved = (c.get("completed", 0) + c.get("failed", 0) + c.get("timed_out", 0)
                    + c.get("drained", 0)
                    + sum(v for k, v in c.items() if k.startswith("shed_admitted{")))
        assert admitted == len(results) + 1        # the re-warm request
        assert resolved == admitted
    finally:
        fe.close()
        time.sleep(1.5)         # any disowned hung tick finishes its sleep
