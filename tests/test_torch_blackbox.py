"""The port's flight recorder and incident bundle against the JAX package's,
on the CPU.

The same script of events goes into a JAX ``FlightRecorder`` and the
port's, each armed with the same ``blackbox`` block: their rings, step
tails, totals, trigger decisions (the bundle count after every event) and
rate-limit suppressions are equal, apart from each event's ``ts``,
``mono`` and ``event_id``. The cases are the JAX recorder tests' (a
bounded ring, a bounded step tail, a clean run with no bundle, an error's
bundle, the ``trigger_severity`` knob, the rate limit, a forced snap,
pruning), and scripts drawn from a numpy seed. The bundles the two write
from the same telemetry directory hold the same files, manifest keys,
tails and truncation notes, under the byte budget and past it.
``SCHEMA_VERSION`` is one in JAX ``telemetry.events``, the port's, and the
port's ``incident.py``; the ``blackbox`` block takes JAX's defaults and
bounds and refuses an unknown key with a hint.
"""

import json
import os

import numpy as np
import pytest

from deepspeed_tpu import blackbox as jbb
from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.runtime.config import BlackboxConfig as JBlackboxConfig
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu_torch import blackbox as tbb
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.runtime.config import BlackboxConfig as TBlackboxConfig
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig

SIDES = {"jax": (jbb, JBlackboxConfig), "torch": (tbb, TBlackboxConfig.from_dict)}
KINDS = ("watchdog_timeout", "chaos_injection", "shed", "breaker_transition",
         "rewind_recovery", "restart", "serving_transition")
SEVERITIES = ("debug", "info", "warning", "error", "critical")


@pytest.fixture(autouse=True)
def _teardown():
    yield
    jbb.deconfigure()
    tbb.deconfigure()
    jtel.deconfigure()
    ttel.deconfigure()


def _armed(tmp_path, **over):
    """One recorder per package, each writing under its own directory."""
    recs = {}
    for side, (bb, make_cfg) in SIDES.items():
        kw = {"output_dir": str(tmp_path / side), "min_trigger_interval_s": 0.0,
              "signal_snap": False, **over}
        recs[side] = bb.configure(make_cfg(kw) if side == "torch" else make_cfg(**kw))
    return recs


def _strip(ev):
    return {k: v for k, v in ev.items() if k not in ("ts", "mono", "event_id")}


def _drive(side, rec, script):
    """Run ``script`` on ``rec``; after each op, the bundles written so far."""
    trace = []
    for op in script:
        if op[0] == "step":
            rec.on_step(op[1])
        elif op[0] == "record":
            rec.record(*op[1:3], op[3], step=op[4])
        else:
            assert SIDES[side][0].snap(op[1]) is not None
        trace.append(rec.bundles_written)
    return trace


def _state(rec, trace):
    inc = os.path.join(rec.output_dir(), "incidents")
    names = sorted(os.listdir(inc)) if os.path.isdir(inc) else []
    return {"ring": [_strip(e) for e in rec.ring_snapshot()],
            "step_tail": [{k: v for k, v in t.items() if k != "ts"}
                          for t in rec.step_tail_snapshot()],
            "events_total": rec.events_total, "errors_total": rec.errors_total,
            "bundles_written": rec.bundles_written, "last_trigger": rec.last_trigger,
            "last_step": rec.last_step, "steps_seen": rec.steps_seen(),
            "bundles_after_each_op": trace,
            "bundle_triggers": sorted(n.split("_", 1)[1].split(".")[0] for n in names)}


def _records(kind, severity, n, step0=0):
    return [("record", kind, severity, {"i": i}, step0 + i) for i in range(n)]


def _seeded_script(seed, n=40):
    rng = np.random.RandomState(seed)
    script = []
    for i in range(n):
        if rng.rand() < 0.3:
            script.append(("step", int(i)))
        else:
            payload = {"i": int(i), "x": float(np.round(rng.randn(), 6))}
            step = int(rng.randint(0, 50)) if rng.rand() < 0.7 else None
            script.append(("record", KINDS[rng.randint(len(KINDS))],
                           SEVERITIES[rng.randint(len(SEVERITIES))], payload, step))
    return script


# the cases of the JAX recorder tests, and seeded scripts: (config, script)
CASES = {
    "ring_bounded_totals_not": ({"ring_size": 4}, _records("chaos_injection", "warning", 10)),
    "step_tail_bounded": ({"metric_tail": 3}, [("step", i) for i in range(7)]),
    "clean_run_zero_bundles": ({}, [("record", "fleet_resize", "warning", {"kind": "grow"}, None),
                                    ("record", "rewind_recovery", "info", {"tier": "ram"}, None)]),
    "error_triggers_bundle": ({}, [("step", 5), ("record", "sdc_verdict", "error",
                                                 {"device": 5}, 6)]),
    "trigger_severity_knob": ({"trigger_severity": "critical"},
                              [("record", "watchdog_timeout", "error", {}, None),
                               ("record", "watchdog_timeout", "critical", {}, None)]),
    "rate_limit_one_bundle_per_interval": (
        {"min_trigger_interval_s": 3600.0},
        [("record", "watchdog_timeout", "error", {"kind": "stall"}, None),
         ("record", "sdc_verdict", "error", {"device": 1}, None)]),
    "snap_forces_bundle": ({}, [("record", "shed", "warning", {"reason": "queue_full"}, None),
                                ("snap", "manual")]),
    "pruning_keeps_newest": ({"max_bundles": 2}, _records("watchdog_timeout", "error", 3)),
    "seeded_0": ({"ring_size": 16, "metric_tail": 8}, _seeded_script(0)),
    "seeded_1": ({"ring_size": 64, "trigger_severity": "warning",
                  "min_trigger_interval_s": 3600.0}, _seeded_script(1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_recorder_equals_jax(tmp_path, case):
    cfg, script = CASES[case]
    recs = _armed(tmp_path, **cfg)
    got = {side: _state(rec, _drive(side, rec, script)) for side, rec in recs.items()}
    assert got["torch"] == got["jax"]
    assert recs["torch"].overhead_us() > 0.0
    if case == "ring_bounded_totals_not":
        assert [e["payload"]["i"] for e in got["torch"]["ring"]] == [6, 7, 8, 9]
    if case == "rate_limit_one_bundle_per_interval":
        assert got["torch"]["bundles_after_each_op"] == [1, 1]


def test_module_level_unarmed_and_reconfigure(tmp_path):
    for side, (bb, make_cfg) in SIDES.items():
        bb.deconfigure()
        assert bb.record("x", "error", {}) is None and bb.snap() is None
        assert bb.get_recorder() is None
    first = _armed(tmp_path)["torch"]
    second = tbb.configure(TBlackboxConfig(output_dir=str(tmp_path / "b2"), signal_snap=False))
    assert tbb.get_recorder() is second and first._closed
    assert tbb.configure(TBlackboxConfig(enabled=False)) is None


def _telemetry_dir(root, metrics_lines, restart_lines=(), rotated_events=0):
    root.mkdir(parents=True)
    (root / "metrics.jsonl").write_text("".join(line + "\n" for line in metrics_lines)
                                        + '{"torn...')
    (root / "restart_log.jsonl").write_text("".join(line + "\n" for line in restart_lines))
    if rotated_events:
        events = [{"name": "fwd", "ph": "X", "ts": float(i), "dur": 1.0, "pid": 0, "tid": 0,
                   "cat": "train", "args": {"step": i, "pad": "y" * 96}}
                  for i in range(rotated_events)]
        (root / "trace.session1.json").write_text(json.dumps({
            "traceEvents": events,
            "metadata": {"rank": 0, "clock_anchor": {"epoch_s": 1.0, "monotonic_s": 0.0}}}))


def _bundle_files(path):
    return {n: open(os.path.join(path, n), "rb").read() for n in sorted(os.listdir(path))}


def test_bundle_contents_equal_jax(tmp_path):
    metrics = [json.dumps({"name": "goodput/mfu", "value": 0.4, "kind": "gauge"})]
    restarts = [json.dumps({"event": "restart", "step": 3, "ts": 123.0})]
    got = {}
    for side, rec in _armed(tmp_path).items():
        _telemetry_dir(tmp_path / side, metrics, restarts)
        rec.config_fingerprint, rec.world_size = "fp123", 1
        rec.on_step(3)
        rec.record("gray_verdict", "error", {"device": 3}, step=3)
        got[side] = _bundle_files(rec.last_bundle_dir)
    assert list(got["torch"]) == list(got["jax"]) == sorted(
        ["events.jsonl", "step_tail.jsonl", "metrics_tail.jsonl", "trace_tail.jsonl",
         "restart_log.jsonl", "env.json", "stacks.txt", "manifest.json"])
    man = {side: json.loads(files["manifest.json"]) for side, files in got.items()}
    assert set(man["torch"]) == set(man["jax"])
    for key in ("schema_version", "trigger", "rank", "world_size", "config_fingerprint",
                "events_total", "errors_total", "ring_len", "last_step", "budget_bytes",
                "notes", "files"):
        assert man["torch"][key] == man["jax"][key], key
    assert man["torch"]["config_fingerprint"] == "fp123" and man["torch"]["trigger"] \
        == "gray_verdict"
    assert set(man["torch"]["clock_anchor"]) == {"epoch_s", "monotonic_s"}
    for name in ("metrics_tail.jsonl", "restart_log.jsonl", "trace_tail.jsonl"):
        assert got["torch"][name] == got["jax"][name], name
    events = {side: [_strip(json.loads(line)) for line in files["events.jsonl"].splitlines()]
              for side, files in got.items()}
    assert events["torch"] == events["jax"]
    stacks = got["torch"]["stacks.txt"].decode()
    assert "Current thread" in stacks and "File " in stacks
    assert "faulthandler failed" not in stacks
    env = json.loads(got["torch"]["env.json"])
    assert set(env) == set(json.loads(got["jax"]["env.json"])) - {"error"} | {"software",
                                                                           "hardware"}
    assert dict(env["software"])["deepspeed_tpu_torch"] and "jax" not in dict(env["software"])
    assert dict(env["hardware"])["backend"] == "cpu"
    assert all(k in ("CUDA_VISIBLE_DEVICES", "PYTORCH_CUDA_ALLOC_CONF", "TORCH_CUDA_ARCH_LIST")
               or k.startswith("NCCL_") for k in env["env"])
    assert not [n for n in os.listdir(tmp_path / "torch" / "incidents") if n.endswith(".tmp")]


@pytest.mark.parametrize("over_budget", [False, True], ids=["tails_capped", "backstop"])
def test_bundle_byte_budget_equals_jax(tmp_path, over_budget):
    big = json.dumps({"name": "goodput/step_wall_s", "value": 1.0, "pad": "x" * 512})
    notes, sizes = {}, {}
    for side, rec in _armed(tmp_path, max_bundle_mb=0.05).items():
        _telemetry_dir(tmp_path / side, [big] * 4096, [big] * 4096 if over_budget else (),
                       rotated_events=600 if over_budget else 0)
        rec.record("watchdog_timeout", "error", {})
        b = rec.last_bundle_dir
        notes[side] = json.loads(open(os.path.join(b, "manifest.json")).read())["notes"]
        sizes[side] = {n: os.path.getsize(os.path.join(b, n))
                       for n in ("metrics_tail.jsonl", "trace_tail.jsonl", "restart_log.jsonl")}
        if not over_budget:
            total = sum(os.path.getsize(os.path.join(b, n)) for n in os.listdir(b))
            assert total <= int(0.05 * 1024 * 1024) + 4096, side
    assert notes["torch"] == notes["jax"]
    assert sizes["torch"] == sizes["jax"]
    cap = int(int(0.05 * (1 << 20)) * 0.35)
    assert f"metrics_tail.jsonl: source truncated to last {cap} bytes" in notes["torch"]
    if over_budget:
        assert any("emptied" in n for n in notes["torch"])
        assert "trace_tail trimmed to byte budget" in notes["torch"]


def test_schema_version_agrees_in_three_places():
    from deepspeed_tpu.telemetry import events as jevents
    from deepspeed_tpu_torch.blackbox import incident as tincident
    from deepspeed_tpu_torch.telemetry import events as tevents

    assert tincident.SCHEMA_VERSION == tevents.SCHEMA_VERSION == jevents.SCHEMA_VERSION == 1
    assert set(tincident._SEVERITY_RANK) == set(tevents.SEVERITIES) == set(jevents.SEVERITIES)
    assert tbb.SCHEMA_VERSION == jbb.SCHEMA_VERSION


def test_config_defaults_and_bounds_equal_jax():
    import dataclasses

    t, j = TBlackboxConfig(), JBlackboxConfig()
    names = [f.name for f in dataclasses.fields(TBlackboxConfig)]
    assert set(names) == set(JBlackboxConfig.model_fields)
    assert {n: getattr(t, n) for n in names} == {n: getattr(j, n) for n in names}
    for bad in ({"ring_size": 0}, {"metric_tail": 0}, {"span_tail": 0}, {"max_bundle_mb": 0.0},
                {"max_bundles": 0}, {"min_trigger_interval_s": -1.0}):
        with pytest.raises(ValueError):
            JBlackboxConfig(**bad)
        with pytest.raises(ValueError):
            TBlackboxConfig.from_dict(bad)
    with pytest.raises(ValueError, match="ring_size"):
        TBlackboxConfig.from_dict({"ring_sze": 64})
    with pytest.raises(ValueError, match="did you mean 'ring_size'"):
        TConfig({"train_batch_size": 8, "blackbox": {"ring_sze": 64}})
    for block, present in ((None, False), ({}, True), ({"enabled": False}, True)):
        pd = {"train_batch_size": 8, **({} if block is None else {"blackbox": block})}
        tc, jc = TConfig(dict(pd)), JConfig(dict(pd))
        assert tc.blackbox_present is jc.blackbox_present is present
        assert tc.blackbox.enabled == jc.blackbox.enabled
