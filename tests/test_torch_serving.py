"""The port's serving front-end against the JAX package's, on the CPU.

A tiny GPT-2 (vocab 256, n_embd 64, 2 layers, 4 heads, fp32,
``max_out_tokens`` 64, ticks of 4 tokens) with the JAX package's weights
copied exactly (``params_from_jax``) serves the same numpy prompts through
both front-ends. Greedy tokens must equal the JAX front-end's and the
port's ``generate`` exactly, post-EOS padding included; sampled tokens
equal the port's ``generate`` with the same seed (the two frameworks' random
streams differ, so not JAX's). Each shed reason carries the JAX fields;
the KV sizing and the capacity are JAX's to the byte; one scripted chaos
drill runs through both front-ends and ends in the same statuses and
counts, which satisfy ``admitted == completed + timed_out + drained +
failed + Σ shed_admitted``. The JAX front-end compiles a prefill and a
decode-chunk program per sampling key, so its programs are shared across
this file, as ``tests/unit/test_serving.py`` shares them.
"""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.resilience import chaos as jchaos
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.resilience import chaos as tchaos
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig

SMALL = dict(vocab_size=256, n_positions=128, n_embd=64, n_layer=2, n_head=4)
MAX_OUT, CHUNK = 64, 4
# one program / loop cache and one warm-tick table per package, shared by
# every front-end of the file (they serve one engine with one chunking)
_SHARED = {"jax": ({}, {}), "torch": ({}, {})}


@pytest.fixture(scope="module")
def engines():
    jcfg = jgpt2.GPT2Config(**SMALL, dtype=jnp.float32, remat=False)
    params = jgpt2.GPT2Model(jcfg).init_params(jax.random.PRNGKey(0))
    jcomm.cdb = None
    je = deepspeed_tpu.init_inference(jgpt2.GPT2Model(jcfg),
                                      config={"dtype": "float32", "max_out_tokens": MAX_OUT},
                                      params=params)
    tmodel = tgpt2.params_from_jax(jax.tree.map(np.asarray, params),
                                   tgpt2.GPT2Config(**SMALL, dtype=torch.float32))
    te = deepspeed_tpu_torch.init_inference(tmodel, {"dtype": "float32",
                                                     "max_out_tokens": MAX_OUT}, device="cpu")
    return {"jax": je, "torch": te}


@pytest.fixture(autouse=True)
def _chaos_clean():
    yield
    jchaos.uninstall_chaos()
    tchaos.uninstall_chaos()


def _frontend(side, engine, start=True, shared=True, **serving):
    if side == "jax":
        from deepspeed_tpu.serving import ServingFrontEnd
        Config = JConfig
    else:
        from deepspeed_tpu_torch.serving import ServingFrontEnd
        Config = TConfig
    serving.setdefault("decode_tick_tokens", CHUNK)
    serving.setdefault("max_queue_depth", 8)
    fe = ServingFrontEnd(engine, Config({"serving": serving}).serving, start=False)
    if shared:
        fe._programs, fe._warm = _SHARED[side]
    if start:
        fe.start()
    return fe


def _both(engines, **kw):
    return {side: _frontend(side, engines[side], **kw) for side in ("jax", "torch")}


def _prompt(n=8, base=0):
    return (np.arange(base, base + n)[None, :] % 256).astype(np.int32)


def _close(fes):
    for fe in fes.values():
        fe.close()


@pytest.mark.parametrize("n,base,new", [(8, 0, 12), (5, 30, 10), (17, 100, 23)])
def test_greedy_tokens_equal_jax_frontend_and_generate(engines, n, base, new):
    fes = _both(engines)
    try:
        got, streamed = {}, []
        for side, fe in fes.items():
            chunks = []
            r = fe.submit(_prompt(n, base), max_new_tokens=new, stream=chunks.append)
            r.result(timeout=300)
            assert r.status == "completed" and r.reason == "", (side, r)
            got[side] = r.tokens
            streamed.append([t for c in chunks for t in c])
        ref = engines["torch"].generate(_prompt(n, base), max_new_tokens=new)[0, n:].tolist()
        assert got["torch"] == got["jax"] == ref
        assert streamed == [got["jax"], got["torch"]]
    finally:
        _close(fes)


def test_eos_padding_equals_jax_and_generate(engines):
    te = engines["torch"]
    free = te.generate(_prompt(), max_new_tokens=12)[0, 8:].tolist()
    eos = free[5]                   # a token the request emits mid-way
    fes = _both(engines)
    try:
        got = {side: fe.submit(_prompt(), max_new_tokens=12, eos_token_id=eos)
               .result(timeout=300).tokens for side, fe in fes.items()}
    finally:
        _close(fes)
    ref = te.generate(_prompt(), max_new_tokens=12, eos_token_id=eos)[0, 8:].tolist()
    assert got["torch"] == got["jax"] == ref
    first = ref.index(eos)
    assert ref[first:] == [eos] * (12 - first)


def test_sampled_tokens_equal_port_generate(engines):
    fe = _frontend("torch", engines["torch"])
    try:
        sample = dict(do_sample=True, temperature=0.8, top_k=12, seed=7)
        r = fe.submit(_prompt(), max_new_tokens=10, **sample).result(timeout=300)
        assert r.status == "completed"
        ref = engines["torch"].generate(_prompt(), max_new_tokens=10, **sample)
        assert r.tokens == ref[0, 8:].tolist()
        # another seed draws another stream through the same loop
        r2 = fe.submit(_prompt(), max_new_tokens=10, **{**sample, "seed": 8}).result(300)
        ref2 = engines["torch"].generate(_prompt(), max_new_tokens=10, **{**sample, "seed": 8})
        assert r2.tokens == ref2[0, 8:].tolist() != r.tokens
    finally:
        fe.close()


def _shed(fe, **submit):
    from deepspeed_tpu.serving import ShedError as JShed
    from deepspeed_tpu_torch.serving import ShedError as TShed

    with pytest.raises((JShed, TShed)) as ei:
        fe.submit(**submit)
    e = ei.value
    return (e.reason, e.queue_depth, round(e.est_wait_s, 6), round(e.retry_after_s, 6))


def _setup_queue_full(fe):
    fe.submit(_prompt(), max_new_tokens=4)
    fe.submit(_prompt(base=8), max_new_tokens=4)
    return _shed(fe, prompt=_prompt(base=16), max_new_tokens=4)


def _setup_deadline(fe):
    fe._service_ema = 0.5              # a warmed server's estimate
    fe.submit(_prompt(), max_new_tokens=4)
    fe.submit(_prompt(base=8), max_new_tokens=4)
    return _shed(fe, prompt=_prompt(base=16), max_new_tokens=4, deadline_s=0.2)


def _setup_variants(fe):
    fe._programs = {}                  # nothing built yet
    fe.submit(_prompt(), max_new_tokens=4, do_sample=True, temperature=0.5)
    shed = _shed(fe, prompt=_prompt(), max_new_tokens=4, do_sample=True, temperature=0.6)
    # the variant already queued still admits
    fe.submit(_prompt(base=8), max_new_tokens=4, do_sample=True, temperature=0.5)
    return shed


def _setup_draining(fe):
    fe.submit(_prompt(), max_new_tokens=4)
    fe.begin_drain("signal")
    return _shed(fe, prompt=_prompt(), max_new_tokens=4)


def _setup_circuit(fe):
    fe.submit(_prompt(), max_new_tokens=4)
    for _ in range(2):
        fe.breaker.record_failure()     # two failed ticks open the circuit
    shed = _shed(fe, prompt=_prompt(), max_new_tokens=4)
    assert 0 < shed[3] <= 30.0
    return shed[:3]                    # the retry-after is the cooldown left: clock-bound


SHEDS = {"queue_full": (_setup_queue_full, {"max_queue_depth": 2}),
         "deadline_unreachable": (_setup_deadline, {}),
         "sampling_variant_limit": (_setup_variants, {"max_program_variants": 1}),
         "draining": (_setup_draining, {}),
         "circuit_open": (_setup_circuit, {"breaker_threshold": 2,
                                           "breaker_cooldown_s": 30.0})}


@pytest.mark.parametrize("reason", sorted(SHEDS))
def test_shed_reasons_and_fields_match_jax(engines, reason):
    setup, serving = SHEDS[reason]
    fes = _both(engines, start=False, shared=False, **serving)
    try:
        got = {side: setup(fe) for side, fe in fes.items()}
        counts = {side: dict(fe.counts) for side, fe in fes.items()}
        states = {side: (fe.state, fe.breaker.state) for side, fe in fes.items()}
    finally:
        _close(fes)
    assert got["torch"] == got["jax"] and got["torch"][0] == reason
    assert counts["torch"] == counts["jax"]
    assert counts["torch"][f"shed{{reason={reason}}}"] == 1
    assert states["torch"] == states["jax"]


def test_oversized_request_is_a_value_error_not_a_shed(engines):
    fes = _both(engines, start=False, shared=False)
    try:
        for fe in fes.values():
            with pytest.raises(ValueError, match="max_out_tokens"):
                fe.submit(_prompt(32), max_new_tokens=64)       # 96 > 64
            with pytest.raises(ValueError, match="single-sequence"):
                fe.submit(np.zeros((2, 4), np.int32), max_new_tokens=4)
            assert fe.counts["admitted"] == 0
    finally:
        _close(fes)


def test_capacity_and_kv_bytes_equal_jax(engines):
    from deepspeed_tpu.runtime.config import ServingConfig as JServing
    from deepspeed_tpu.serving import kv_bytes_per_request as jkv
    from deepspeed_tpu.serving import resolve_capacity as jcap
    from deepspeed_tpu_torch.runtime.config import ServingConfig as TServing
    from deepspeed_tpu_torch.serving import kv_bytes_per_request as tkv
    from deepspeed_tpu_torch.serving import resolve_capacity as tcap

    je, te = engines["jax"], engines["torch"]
    for length in (1, 64, 1000):
        assert tkv(te.module, length) == jkv(je.module, length) > 0
    for kw in ({"hbm_bytes": 1 << 30, "kv_budget_fraction": 0.5}, {"hbm_bytes": 1 << 20},
               {}, {"max_queue_depth": 3}):
        jc, jd = jcap(je, JServing(**kw))
        tc, td = tcap(te, TServing.from_dict(kw))
        assert (tc, td) == (jc, jd), kw
    # the serving front-ends report it in their status
    fe = _frontend("torch", te, start=False, shared=False, max_queue_depth=0,
                   hbm_bytes=1 << 30)
    try:
        assert fe.status()["capacity_detail"] == jcap(je, JServing(hbm_bytes=1 << 30))[1]
    finally:
        fe.close()


def _drill(side, fe, injector):
    """One scripted drill: a completed request, a hung tick, a failed tick,
    a second completed request, then a slow request in flight with two
    queued behind it, a shed at the door and a drain. → the requests'
    (status, reason, tokens or none), the door's shed reasons, the counts
    (the streamed-token count aside: how far the slow request got before
    the drain cap is a matter of timing), the exit code and the state."""
    from deepspeed_tpu.serving import ShedError as JShed
    from deepspeed_tpu_torch.serving import ShedError as TShed

    (jchaos if side == "jax" else tchaos).install_chaos(injector)
    out = []
    for base in (0, 8, 16, 24):
        r = fe.submit(_prompt(base=base), max_new_tokens=8, deadline_s=120)
        r.result(timeout=300)
        out.append((r.status, r.reason.split(":")[0], "tokens" if r.tokens else "none"))
    first = threading.Event()
    slow = fe.submit(_prompt(base=40), max_new_tokens=16, deadline_s=120,
                     stream=lambda toks: first.set())
    assert first.wait(60)
    queued = [fe.submit(_prompt(base=48 + i), max_new_tokens=8, deadline_s=120)
              for i in range(2)]
    sheds = []
    try:
        fe.submit(_prompt(base=60), max_new_tokens=8, deadline_s=120)
    except (JShed, TShed) as e:
        sheds.append(e.reason)
    fe.begin_drain("signal")
    code = fe.drain(timeout=60)
    for r in (slow, *queued):
        r.result(timeout=60)
        out.append((r.status, r.reason, "tokens" if r.tokens else "none"))
    counts = {k: v for k, v in fe.counts.items() if k != "tokens_streamed"}
    return out, sheds, counts, code, fe.state


def test_scripted_drill_through_both_frontends(engines):
    # ticks: request 1 takes #1-#3 (prefill, 2 chunks of 4); request 2
    # hangs at #5 (its first decode tick, warm, under a 0.8 s cap); request
    # 3 fails at #7; request 4 completes; from #11 on every tick is delayed
    # 0.3 s, so the drain's 0.5 s grace caps the slow request mid-stream
    script = dict(hang_at={"decode_step": [5]}, hang_s=1.5, fail_at={"decode_step": [7]},
                  delay_at={"decode_step": list(range(11, 40))}, max_delay_s=0.3)
    got = {}
    for side in ("jax", "torch"):
        inj = (jchaos if side == "jax" else tchaos).ChaosInjector(**script)
        fe = _frontend(side, engines[side], max_queue_depth=3, breaker_threshold=3,
                       decode_tick_timeout_s=0.8, drain_grace_s=0.5)
        # a request outside the drill warms the shared keys
        fe.submit(_prompt(base=200), max_new_tokens=8).result(timeout=300)
        fe.counts.clear()
        try:
            got[side] = _drill(side, fe, inj)
        finally:
            fe.close()
            (jchaos if side == "jax" else tchaos).uninstall_chaos()
        time.sleep(1.6)                # the disowned hung tick finishes its sleep
    assert got["torch"] == got["jax"]
    out, sheds, counts, code, state = got["torch"]
    assert out[:4] == [("completed", "", "tokens"), ("failed", "timeout", "none"),
                       ("failed", "error", "none"), ("completed", "", "tokens")]
    assert out[4] == ("partial", "drained", "tokens")
    assert out[5:] == [("shed", "draining", "none")] * 2
    assert sheds == ["queue_full"]
    assert code == 87 and state == "dead"
    admitted = counts["admitted"]
    resolved = (counts.get("completed", 0) + counts.get("failed", 0)
                + counts.get("timed_out", 0) + counts.get("drained", 0)
                + sum(v for k, v in counts.items() if k.startswith("shed_admitted{")))
    assert admitted == resolved == 7


def test_strict_noop_without_the_block():
    """Without the ``serving`` block nothing imports the serving package
    and no serving thread starts."""
    from deepspeed_tpu_torch.models.simple import SimpleModel

    mods = [m for m in list(sys.modules) if m == "deepspeed_tpu_torch.serving"
            or m.startswith("deepspeed_tpu_torch.serving.")]
    saved = {m: sys.modules.pop(m) for m in mods}
    try:
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=SimpleModel(hidden_dim=16, nlayers=2),
            config={"train_batch_size": 8, "steps_per_print": 0,
                    "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}, device="cpu")
        engine.train_batch((np.ones((8, 16), np.float32), np.zeros((8, 16), np.float32)))
        ie = deepspeed_tpu_torch.init_inference(
            tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32)),
            {"dtype": "float32", "max_out_tokens": 16}, device="cpu")
        ie.generate(_prompt(4), max_new_tokens=2)
        assert not [m for m in sys.modules if m.startswith("deepspeed_tpu_torch.serving")]
        assert not [t for t in threading.enumerate() if t.name.startswith("ds-serve")]
        cfg = TConfig({})
        assert cfg.serving_present is False
        from deepspeed_tpu_torch.serving import from_ds_config
        assert from_ds_config(ie, cfg) is None
        assert from_ds_config(ie, TConfig({"serving": {"enabled": False}})) is None
    finally:
        sys.modules.update(saved)


def test_int8_engine_serves_its_generate_tokens():
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.bfloat16))
    te = deepspeed_tpu_torch.init_inference(
        model, {"max_out_tokens": MAX_OUT}, dtype=torch.int8,
        quant={"weight": {"num_bits": 8, "quantized_initialization": {"min_numel": 1024}}},
        device="cpu")
    assert te.quantized
    fe = _frontend("torch", te, shared=False)
    try:
        r = fe.submit(_prompt(), max_new_tokens=10).result(timeout=300)
        assert r.status == "completed"
        assert r.tokens == te.generate(_prompt(), max_new_tokens=10)[0, 8:].tolist()
        # the weights the admission bound counts are the stored codes
        assert fe.capacity_detail["source"] == "max_queue_depth"
        from deepspeed_tpu_torch.runtime.config import ServingConfig
        from deepspeed_tpu_torch.serving import resolve_capacity
        _, detail = resolve_capacity(te, ServingConfig(hbm_bytes=1 << 30))
        assert detail["params_bytes"] == te.weight_nbytes()
    finally:
        fe.close()
