"""The goodput ledger against the JAX package, event for event.

Hypothesis draws span lists of several steps: nested and overlapping
``data``, ``train_batch``, ``fwd``, ``bwd``, ``step``, ``comm``,
``compile``, ``stall``, ``checkpoint`` and ``straggler`` spans, background
spans, instants and spans of no bucket, and fleet straggler intervals. The
same list goes to the JAX and the port's ``step_windows``,
``step_ledgers``, ``session_ledger``, ``goodput_fraction`` and
``top_badput``: they agree exactly (the same floats), and every ledger
closes exactly: its buckets sum to its window. The bucket set and its
priority order are JAX's, and so is every span's classification.
"""

import math

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from deepspeed_tpu.goodput import ledger as jledger
from deepspeed_tpu.goodput import taxonomy as jtax
from deepspeed_tpu_torch.goodput import ledger as tledger
from deepspeed_tpu_torch.goodput import taxonomy as ttax

STEP_SPANS = ("train_batch", "fwd", "bwd", "step")
OTHER = (("comm:all_reduce", "comm"), ("compile", "compile"), ("watchdog_stall", "stall"),
         ("save_checkpoint", "checkpoint"), ("load_checkpoint", "train"),
         ("straggler_wait", "straggler"), ("audit", "audit"), ("probe", "probe"),
         ("prefill", "inference"), ("eigenvalue", "train"))


@st.composite
def span_lists(draw):
    """Several steps, each a data span then a train_batch envelope holding
    fwd / bwd / step leaves, with other spans scattered over and between
    the steps (overlapping anything), some in the background; a few
    events without a duration or a step."""
    events = []
    t = draw(st.floats(0, 1e3))
    steps = draw(st.integers(1, 5))
    first = draw(st.integers(0, 3))
    for i in range(steps):
        step = first + i
        data = draw(st.floats(0, 2e3))
        events.append({"name": "data", "cat": "train", "ph": "X", "ts": t, "dur": data,
                       "pid": 0, "tid": 0, "args": {"step": step}})
        gap = draw(st.floats(0, 500))
        body = draw(st.floats(1, 1e4))
        tb0 = t + data + gap
        if draw(st.booleans()) or i < steps - 1:
            events.append({"name": "train_batch", "cat": "train", "ph": "X", "ts": tb0,
                           "dur": body, "pid": 0, "tid": 0, "args": {"step": step}})
        for name in draw(st.lists(st.sampled_from(STEP_SPANS[1:]), max_size=4)):
            a = draw(st.floats(0, 1)) * body
            b = draw(st.floats(0, 1)) * (body - a)
            events.append({"name": name, "cat": "train", "ph": "X", "ts": tb0 + a, "dur": b,
                           "pid": 0, "tid": 0, "args": {"step": step}})
        t = tb0 + body + draw(st.floats(0, 3e3))
    horizon = t + 1e3
    for name, cat in draw(st.lists(st.sampled_from(OTHER), max_size=12)):
        ts = draw(st.floats(0, horizon))
        args = {"op": "all_reduce", "seq": 0, "group": "world"} if cat == "comm" else {}
        if draw(st.integers(0, 5)) == 0:
            args["background"] = True
        events.append({"name": name, "cat": cat, "ph": "X", "ts": ts,
                       "dur": draw(st.floats(0, 5e3)), "pid": 0, "tid": 0, "args": args})
    if draw(st.booleans()):
        events.append({"name": "sentinel_rewind", "cat": "resilience", "ph": "i", "s": "p",
                       "ts": draw(st.floats(0, horizon)), "pid": 0, "tid": 0, "args": {}})
    events = draw(st.permutations(events))
    stragglers = sorted(
        (a, a + d) for a, d in draw(st.lists(st.tuples(st.floats(0, horizon),
                                                        st.floats(0, 2e3)), max_size=4)))
    return list(events), stragglers or None


def _closes(led):
    assert math.isclose(sum(led["buckets"].values()), led["wall_us"], rel_tol=1e-12,
                        abs_tol=1e-6)


def test_buckets_and_classification_are_jax():
    assert ttax.BUCKETS == jtax.BUCKETS
    assert ttax.GOODPUT_BUCKETS == jtax.GOODPUT_BUCKETS
    assert ttax.BADPUT_BUCKETS == jtax.BADPUT_BUCKETS
    assert ttax.COMPUTE_SPANS == jtax.COMPUTE_SPANS
    for name, cat in OTHER + tuple((n, "train") for n in STEP_SPANS + ("data", "other")):
        for background in (False, True):
            ev = {"name": name, "cat": cat, "ph": "X", "ts": 0.0, "dur": 1.0,
                  "args": {"background": background}}
            assert ttax.span_bucket(ev) == jtax.span_bucket(ev), (name, cat, background)


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(span_lists())
def test_ledgers_equal_jax_event_for_event(drawn):
    events, stragglers = drawn
    assert tledger.step_windows(events) == jledger.step_windows(events)
    for straggler in (None, stragglers):
        got = tledger.step_ledgers(events, straggler_intervals=straggler)
        want = jledger.step_ledgers(events, straggler_intervals=straggler)
        assert got == want
        for led in got:
            _closes(led)
            assert tledger.goodput_fraction(led["buckets"]) == \
                jledger.goodput_fraction(led["buckets"])
            assert tledger.top_badput(led["buckets"]) == jledger.top_badput(led["buckets"])
        got = tledger.session_ledger(events, straggler_intervals=straggler)
        assert got == jledger.session_ledger(events, straggler_intervals=straggler)
        if got is not None:
            _closes(got)
            total = tledger.sum_buckets([led["buckets"] for led in got["steps"]])
            assert total == jledger.sum_buckets([led["buckets"] for led in got["steps"]])
            assert tledger.goodput_fraction(total) == jledger.goodput_fraction(total)
            assert tledger.top_badput(got["buckets"]) == jledger.top_badput(got["buckets"])


@pytest.mark.parametrize("window", [(0.0, 10_000.0), (1_500.0, 6_000.0), (5.0, 5.0)])
def test_classify_window_is_jax_on_the_reference_fixture(window):
    """JAX's own fixture (``tests/unit/test_goodput.py``): data wait, a
    train_batch envelope, a compile burst and a collective inside it, a
    checkpoint after it; compile wins over the envelope, the collective
    the envelope contains is exposed."""
    span = lambda name, ts, dur, cat="train", **args: {
        "name": name, "cat": cat, "ph": "X", "ts": float(ts), "dur": float(dur), "pid": 0,
        "tid": 0, "args": args}
    events = [span("data", 0, 1000, step=0), span("train_batch", 1000, 8000, step=0),
              span("compile", 1500, 2000, cat="compile"),
              span("all_reduce", 5000, 1000, cat="comm", op="all_reduce", seq=0, group=""),
              span("save_checkpoint", 9000, 500, cat="checkpoint")]
    got = tledger.classify_window(events, window)
    assert got == jledger.classify_window(events, window)
    assert math.isclose(sum(got.values()), max(0.0, window[1] - window[0]), abs_tol=1e-9)
    if window == (0.0, 10_000.0):
        assert got["compile"] == 2000.0 and got["exposed_comm"] == 1000.0
        assert got["checkpoint"] == 500.0 and got["data_wait"] == 1000.0
