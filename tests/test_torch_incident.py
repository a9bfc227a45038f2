"""The port's incident report (``ds_incident``) against the JAX package's,
both ways, on the CPU.

Each case writes its bundles with one package's bundle writer (a
``FlightRecorder`` whose ring holds the case's events, at fixed times,
over a telemetry directory with the case's metrics, restart log and trace
session), then degrades them as the case asks: a torn ``events.jsonl``
tail, a foreign schema version, a half-written ``.tmp`` bundle. The
port's ``build_report`` over those bundles equals the JAX
``build_report``: the bundles, the timeline in its order with its aligned
times, the alignment mode and offsets, the first cause, the recovery and
cost, and the warnings, and ``render_report`` prints the same text. Every
case of the JAX incident tests is here (the two-rank merge, torn tails,
a missing rank, two bundles claiming one rank, fingerprints that
disagree, overlapping sessions, mixed schema versions, ``.tmp`` bundles,
each rung of the first-cause ladder, recovery and cost from restart
records, elision, an empty directory) with bundles of either writer, and a
merge aligned on matched collectives. The command line gives JAX's output
and exit codes.

Where the port reads what JAX misses: a restart record as the elastic
agent writes it (the recovery's fields flat, not under ``recovery``) gives
the port's report its recovery and JAX's none.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import uuid

import pytest

from deepspeed_tpu.blackbox import bundle as jbundle
from deepspeed_tpu.blackbox import incident as jincident
from deepspeed_tpu.blackbox.recorder import FlightRecorder as JRecorder
from deepspeed_tpu.runtime.config import BlackboxConfig as JBlackboxConfig
from deepspeed_tpu_torch.blackbox import bundle as tbundle
from deepspeed_tpu_torch.blackbox import incident as tincident
from deepspeed_tpu_torch.blackbox.recorder import FlightRecorder as TRecorder
from deepspeed_tpu_torch.runtime.config import BlackboxConfig as TBlackboxConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRITERS = {"jax": (JRecorder, JBlackboxConfig, jbundle),
           "torch": (TRecorder, TBlackboxConfig, tbundle)}


def ev(kind, severity, ts, rank, step=None, payload=None, eid=None, schema_version=1):
    return {"schema_version": schema_version, "event_id": eid or uuid.uuid4().hex[:12],
            "ts": ts, "mono": ts, "step": step, "rank": rank, "kind": kind,
            "severity": severity, "payload": payload or {}}


def _jsonl(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def write_bundle(writer, root, name, rank, events, world_size=None, fingerprint="fp",
                 restart=(), trace=(), metrics=(), schema_version=1, torn_tail=False):
    """A bundle of ``writer``'s bundle writer under ``root/incidents/name``."""
    Recorder, Config, bmod = WRITERS[writer]
    stage = os.path.join(str(root), "_stage", name)
    os.makedirs(stage)
    _jsonl(os.path.join(stage, "metrics.jsonl"), metrics)
    _jsonl(os.path.join(stage, "restart_log.jsonl"), restart)
    if trace:
        with open(os.path.join(stage, "trace.session1.json"), "w") as f:
            json.dump({"traceEvents": list(trace), "metadata": {
                "rank": rank, "clock_anchor": {"epoch_s": 1000.0, "monotonic_s": 0.0}}}, f)
    rec = Recorder(Config(signal_snap=False, output_dir=stage), rank=rank)
    rec.world_size, rec.config_fingerprint = world_size, fingerprint
    for e in events:
        rec._ring.append(e)
    path = bmod.write_bundle(rec, "test", stage)
    rec.close()
    final = os.path.join(str(root), "incidents", name)
    os.makedirs(os.path.dirname(final), exist_ok=True)
    shutil.move(path, final)
    shutil.rmtree(stage)
    if schema_version != 1:
        mpath = os.path.join(final, "manifest.json")
        with open(mpath) as f:
            man = json.load(f)
        with open(mpath, "w") as f:
            json.dump({**man, "schema_version": schema_version}, f)
    if torn_tail:
        with open(os.path.join(final, "events.jsonl"), "a") as f:
            f.write('{"kind": "cut-mid-wr')
    return final


def _comm(seq, end_us, dur=100.0):
    return {"name": "all_reduce", "cat": "comm", "ph": "X", "ts": end_us - dur, "dur": dur,
            "pid": 0, "tid": 0, "args": {"op": "all_reduce", "seq": seq, "group": "dp"}}


# each case: (bundles under tmp_path as [(subdir, name, rank, events, kwargs)], check)
def _two_rank(w, root):
    write_bundle(w, root, "a_r0", 0, [ev("watchdog_timeout", "error", 1002.0, 0, step=9),
                                      ev("shed", "warning", 1001.0, 0)], world_size=2)
    write_bundle(w, root, "b_r1", 1, [ev("gray_verdict", "error", 1000.5, 1, step=8,
                                         payload={"device": 3, "kind": "slow-compute"})],
                 world_size=2)


def _torn(w, root):
    write_bundle(w, root, "a_r0", 0, [ev("watchdog_timeout", "error", 1000.0, 0)],
                 torn_tail=True)


def _missing_rank(w, root):
    write_bundle(w, root, "a_r0", 0, [ev("watchdog_timeout", "error", 1000.0, 0)],
                 world_size=3)
    write_bundle(w, root, "b_r2", 2, [ev("shed", "warning", 1001.0, 2)], world_size=3)


def _one_rank_twice(w, root):
    shared = ev("watchdog_timeout", "error", 1000.0, 0, eid="aaaaaaaaaaaa")
    write_bundle(w, root, "a_r0", 0, [shared])
    write_bundle(w, root, "b_r0_again", 0, [shared, ev("shed", "warning", 1001.0, 0)])


def _fingerprints(w, root):
    write_bundle(w, root, "a_r0", 0, [ev("watchdog_timeout", "error", 1000.0, 0)],
                 fingerprint="fpA")
    write_bundle(w, root, "b_r0", 0, [ev("shed", "warning", 2000.0, 0)], fingerprint="fpB")


def _overlap(w, root):
    write_bundle(w, root, "a_r0", 0, [ev("shed", "warning", 1000.0, 0),
                                      ev("shed", "warning", 1010.0, 0)])
    write_bundle(w, root, "b_r0", 0, [ev("shed", "warning", 1005.0, 0),
                                      ev("shed", "warning", 1015.0, 0)])


def _schema(w, root):
    write_bundle(w, root, "a_r0", 0, [ev("watchdog_timeout", "error", 1000.0, 0,
                                         schema_version=99)], schema_version=99)


def _tmp_bundle(w, root):
    write_bundle(w, root, "a_r0", 0, [ev("watchdog_timeout", "error", 1000.0, 0)])
    os.makedirs(os.path.join(str(root), "incidents", "b_r1.tmp"))


def _verdict_first(w, root):
    write_bundle(w, root, "a_r0", 0, [ev("watchdog_timeout", "error", 1000.0, 0),
                                      ev("sdc_verdict", "error", 1005.0, 0,
                                         payload={"device": 5, "kind": "corruption"})])


def _error_first(w, root):
    write_bundle(w, root, "a_r0", 0, [ev("shed", "warning", 999.0, 0),
                                      ev("watchdog_timeout", "error", 1000.0, 0)])


def _restart_first(w, root):
    write_bundle(w, root, "a_r0", 0, [ev("shed", "warning", 999.0, 0)],
                 restart=[{"event": "restart", "ts": 998.0, "step": 3}])


def _skew_first(w, root):
    write_bundle(w, root, "a_r0", 0, [ev("shed", "warning", 999.0, 0)],
                 metrics=[{"name": "comm/latency_skew", "value": 4.2}])


def _no_evidence(w, root):
    write_bundle(w, root, "a_r0", 0, [ev("shed", "warning", 999.0, 0)])


def _recovery_cost(w, root):
    write_bundle(w, root, "a_r0", 0, [ev("gray_verdict", "error", 1000.0, 0,
                                         payload={"device": 3, "kind": "slow-compute"})],
                 restart=[{"event": "restart", "ts": 1001.0, "step": 12, "backoff_s": 1.5,
                           "recovery": {"tier": "ram", "steps_lost": 2, "restore_s": 0.5,
                                        "resize": {"kind": "shrink", "from": 8, "to": 6}}}])


def _elision(w, root):
    events = [ev("shed", "warning", 1000.0 + i, 0) for i in range(30)]
    write_bundle(w, root, "a_r0", 0, events + [ev("watchdog_timeout", "error", 1031.0, 0)])


def _empty(w, root):
    os.makedirs(os.path.join(str(root), "nothing_here"))


def _aligned(w, root):
    # rank 1's clock runs 0.5 s ahead: its collectives end 0.5 s "later"
    trace0 = [_comm(i, 1e6 * (i + 1)) for i in range(4)]
    trace1 = [_comm(i, 1e6 * (i + 1) + 5e5) for i in range(4)]
    write_bundle(w, root, "a_r0", 0, [ev("watchdog_timeout", "error", 1000.3, 0)],
                 world_size=2, trace=trace0)
    write_bundle(w, root, "b_r1", 1, [ev("chaos_injection", "warning", 1000.6, 1)],
                 world_size=2, trace=trace1)


def _has(text):
    return lambda rep: any(text in w for w in rep["warnings"])


CASES = {
    "two_rank_merge": (_two_rank, lambda rep: rep["ranks"] == [0, 1] and [
        e["kind"] for e in rep["timeline"]] == ["gray_verdict", "shed", "watchdog_timeout"]
        and rep["first_cause"]["device"] == 3
        and not any("missing bundle" in w for w in rep["warnings"])),
    "torn_events_tail": (_torn, lambda rep: len(rep["timeline"]) == 1 and _has("torn")(rep)),
    "missing_rank": (_missing_rank, lambda rep: any(
        "missing bundle" in w and "[1]" in w for w in rep["warnings"])),
    "two_bundles_one_rank": (_one_rank_twice, lambda rep: _has("claimed by 2 bundles")(rep)
                             and [e["kind"] for e in rep["timeline"]].count(
                                 "watchdog_timeout") == 1),
    "fingerprint_disagreement": (_fingerprints, _has("different runs")),
    "overlapping_sessions": (_overlap, _has("overlap in time")),
    "mixed_schema_versions": (_schema, lambda rep: _has("mixed-version fleet")(rep)
                              and _has("foreign schema_version")(rep)
                              and len(rep["timeline"]) == 1),
    "half_written_tmp": (_tmp_bundle, lambda rep: len(rep["bundles"]) == 1 and _has(".tmp")(rep)),
    "first_cause_verdict_beats_earlier_error": (
        _verdict_first, lambda rep: rep["first_cause"]["device"] == 5),
    "first_cause_earliest_error": (
        _error_first, lambda rep: rep["first_cause"]["kind"] == "watchdog_timeout"),
    "first_cause_restart_record": (
        _restart_first, lambda rep: "restart record" in rep["first_cause"]["why"]),
    "first_cause_skew_gauge": (_skew_first, lambda rep: "skew" in rep["first_cause"]["why"]),
    "first_cause_refuses_to_guess": (
        _no_evidence, lambda rep: rep["first_cause"] is None and _has("refusing to guess")(rep)),
    "recovery_and_cost": (_recovery_cost, lambda rep: rep["cost"]["recovery"]["tier"] == "ram"
                          and rep["cost"]["fleet_seconds"] == 2.0),
    "render_elision": (_elision, lambda rep: len(rep["timeline"]) == 31),
    "empty_dir": (_empty, lambda rep: rep["bundles"] == [] and _has("no incident bundles")(rep)),
    "collective_aligned": (_aligned, lambda rep: rep["align_mode"].startswith(
        "collective-aligned") and [e["kind"] for e in rep["timeline"]]
        == ["chaos_injection", "watchdog_timeout"]),
}


def _norm(report):
    return json.loads(json.dumps(report, default=str))


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_report_equals_jax(tmp_path, case, writer):
    build, check = CASES[case]
    build(writer, tmp_path)
    path = str(tmp_path / "nothing_here") if case == "empty_dir" else str(tmp_path)
    got, want = tincident.build_report([path]), jincident.build_report([path])
    assert _norm(got) == _norm(want)
    assert check(got), got
    assert tincident.render_report(got, max_events=10) == \
        jincident.render_report(want, max_events=10)
    if case == "recovery_and_cost":
        text = tincident.render_report(got)
        assert "recovery: tier=ram" in text and "resize 8->6" in text
        assert "first cause: rank 0 device 3" in text
    if case == "render_elision":
        text = tincident.render_report(got, max_events=10)
        assert "more ..." in text and "trigger: test" in text


def test_agent_restart_record_recovery_read_where_jax_misses(tmp_path):
    """The elastic agent stamps the recovery's fields flat on its record;
    the port's report reads them, JAX's finds none."""
    record = {"restart": 1, "error": "WatchdogTimeout: hung", "step": 5, "backoff_s": 0.25,
              "ts": 1001.0, "kind": "restart", "severity": "error", "tier": "ram",
              "snapshot_step": 4, "restore_s": 0.01, "steps_lost": 1}
    write_bundle("torch", tmp_path, "a_r0", 0, [ev("watchdog_timeout", "error", 1000.0, 0,
                                                   step=5)], restart=[record])
    got, want = tincident.build_report([str(tmp_path)]), jincident.build_report([str(tmp_path)])
    assert got["cost"]["recovery"] == {"tier": "ram", "snapshot_step": 4, "steps_lost": 1,
                                       "restore_s": 0.01, "reshard_s": None, "resize": None}
    assert want["cost"]["recovery"] is None
    assert got["cost"]["fleet_seconds"] == want["cost"]["fleet_seconds"] == 0.25
    assert {k: v for k, v in _norm(got).items() if k != "cost"} == \
        {k: v for k, v in _norm(want).items() if k != "cost"}
    assert "recovery: tier=ram, steps_lost=1" in tincident.render_report(got)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_cli_output_and_exit_codes_equal_jax(tmp_path):
    write_bundle("torch", tmp_path, "a_r0", 0, [ev("sdc_verdict", "error", 1000.0, 0,
                                                   payload={"device": 5, "kind": "corruption"})])
    d = str(tmp_path)
    calls = [["report", d], ["report", d, "--json"], ["report", str(tmp_path / "nothing")],
             ["report"], ["list", d], ["list", str(tmp_path / "nothing")], [], ["-h"],
             ["bogus"], ["snap"], ["snap", "--pid", "x"]]
    want_rc = [0, 0, 1, 2, 0, 1, 2, 0, 2, 2, 2]
    for argv, rc in zip(calls, want_rc):
        got, want = _run(tincident.main, list(argv)), _run(jincident.main, list(argv))
        assert got[0] == want[0] == rc, argv
        if argv[-1:] == ["--json"]:
            assert json.loads(got[1])["first_cause"] == json.loads(want[1])["first_cause"]
            assert json.loads(got[1])["first_cause"]["device"] == 5
        else:
            assert got[1] == want[1], argv
    assert "first cause: rank 0 device 5" in _run(tincident.main, ["report", d])[1]
    assert "trigger=test" in _run(tincident.main, ["list", d])[1]
    proc = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.blackbox.incident",
                           "report", d], capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "first cause: rank 0 device 5" in proc.stdout
