"""The fleet-trace aggregate against the JAX package, file for file.

Two spawned gloo ranks train a small fp32 GPT-2 at ZeRO stage 2 with the
``telemetry`` block on, twice: a clean run, and a run in which the chaos
injector delays rank 1 by 0.2 s before the launches of its third step. Each
run is a telemetry session whose per-rank traces (``trace.json``,
``trace.rank1.json``) hold the comm layer's ``cat="comm"`` spans. Both
packages' ``FleetTrace.from_files`` read the same files and give the same
collective matches (op, seq, group and arrivals), clock offsets, straggler
table, per-rank cost, critical path, exposed comm and merged timeline; in
the delayed run rank 1 is the straggler in both. On the ranks: every timed
collective's span carries ``op``, ``seq`` (counted per op and group from
0 in each session), ``group`` and ``bytes``; with telemetry off and no
comms logger nothing is recorded.

JAX's degradation cases (``tests/unit/test_goodput.py``'s merge cases): a
missing rank, two files claiming one rank, a restart mid-trace, empty and
truncated files, and a directory scan that leaves out rotated sessions,
each through both packages with the same result.

The ranks import no JAX: this module imports it inside its functions.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.torch_world import World

SMALL = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2, n_head=2, remat=False,
             use_flash_attention=False)
STEPS, DELAY_STEP, DELAY_S = 4, 3, 0.2


def _train(rank, world, out_dir, name, delay):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.models import gpt2 as tgpt2
    from deepspeed_tpu_torch.resilience import chaos

    if delay and rank == 1:
        chaos.install_chaos(chaos.ChaosInjector(delay_at={"train_step": [DELAY_STEP]},
                                                max_delay_s=DELAY_S))
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32)).init_params(
        torch.Generator().manual_seed(0))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, device="cpu", config={
        "train_batch_size": 8, "steps_per_print": 0,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
        "zero_optimization": {"stage": 2},
        "telemetry": {"enabled": True, "output_dir": os.path.join(out_dir, name),
                      "flush_interval": 1000}})
    ids = np.random.RandomState(1).randint(0, SMALL["vocab_size"], size=(8, 32))
    for _ in range(STEPS):
        engine.train_batch({"input_ids": ids[rank::world]})
    spans = [e for e in telemetry.get_tracer().events if e.get("cat") == "comm"]
    telemetry.deconfigure()
    chaos.uninstall_chaos()
    return spans


def _ranks(rank, world, out_dir):
    from deepspeed_tpu_torch import comm, telemetry
    from deepspeed_tpu_torch.comm import comm as comm_module

    out = {name: _train(rank, world, out_dir, name, delay)
           for name, delay in (("clean", False), ("delayed", True))}
    # telemetry off and no comms logger: a collective records nothing
    assert telemetry.get_session() is None and comm_module.comms_logger is None
    comm_module.reset_collective_trace_seq()
    comm.all_reduce(torch.ones(4))
    out["off_seq_counters"] = dict(comm_module._collective_trace_seq)
    out["off_events"] = list(telemetry.get_tracer().events)
    # a group of some of the ranks goes by their global ranks
    from deepspeed_tpu_torch.runtime.config import TelemetryConfig

    sub = comm.new_group([1])
    telemetry.configure(TelemetryConfig(enabled=True, output_dir=os.path.join(out_dir, "sub")))
    if rank == 1:
        comm.all_reduce(torch.ones(2), group=sub)
    out["sub_groups"] = [e["args"]["group"] for e in telemetry.get_tracer().events
                         if e.get("cat") == "comm"]
    telemetry.deconfigure()
    return out


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("aggregate"))
    spans = World(_ranks, 2, out).join()
    return {"dir": out, "spans": spans}


def _files(fleet, name):
    d = os.path.join(fleet["dir"], name)
    return [os.path.join(d, "trace.json"), os.path.join(d, "trace.rank1.json")]


def _both(paths):
    from deepspeed_tpu.profiling import aggregate as jagg
    from deepspeed_tpu_torch.profiling import aggregate as tagg

    return tagg.FleetTrace.from_files(paths), jagg.FleetTrace.from_files(paths)


def test_comm_spans_carry_the_rank_matchable_identity(fleet):
    for rank, by in enumerate(fleet["spans"]):
        for name in ("clean", "delayed"):
            spans = by[name]
            assert spans, (rank, name)
            seqs = {}
            for ev in spans:
                args = ev["args"]
                assert ev["name"] == f"comm:{args['op']}" and ev["ph"] == "X"
                assert args["group"] == "world" and args["bytes"] > 0
                seqs.setdefault((args["op"], args["group"]), []).append(args["seq"])
            # counted per (op, group) from 0 in each session
            for seq in seqs.values():
                assert seq == list(range(len(seq)))
            assert {"reduce_scatter_tensor", "all_reduce",
                    "all_gather_into_tensor"} <= {op for op, _ in seqs}
        assert by["off_seq_counters"] == {} and by["off_events"] == []
        assert by["sub_groups"] == (["ranks:1"] if rank == 1 else [])
    # every rank issues the same collectives
    assert [e["args"]["op"] for e in fleet["spans"][0]["clean"]] == \
        [e["args"]["op"] for e in fleet["spans"][1]["clean"]]


@pytest.mark.parametrize("name", ["clean", "delayed"])
def test_fleet_trace_equals_jax_file_for_file(fleet, name):
    port, ref = _both(_files(fleet, name))
    assert sorted(port.by_rank) == sorted(ref.by_rank) == [0, 1]
    assert port.clock_offsets() == ref.clock_offsets()
    matches = port.collective_matches()
    assert [tuple(m) for m in matches] == [tuple(m) for m in ref.collective_matches()]
    assert len(matches) == len(fleet["spans"][0][name])
    assert port.straggler_table(top_k=5) == ref.straggler_table(top_k=5)
    assert port.rank_cost_summary() == ref.rank_cost_summary()
    assert port.steps() == ref.steps() == list(range(STEPS))
    for step in (None, 0, STEPS - 1):
        assert port.critical_path(step=step) == ref.critical_path(step=step)
        assert port.exposed_comm_us(step=step) == ref.exposed_comm_us(step=step)
    assert port.exposed_comm_summary() == ref.exposed_comm_summary()
    assert port.to_chrome_trace() == ref.to_chrome_trace()
    assert port.warnings == ref.warnings


def test_the_delayed_rank_is_the_straggler_in_both(fleet):
    port, ref = _both(_files(fleet, "delayed"))
    for ft in (port, ref):
        top = ft.straggler_table(top_k=1)[0]
        assert top.rank == 1 and top.fleet_cost_us > 0.5 * DELAY_S * 1e6, top
        cost = ft.rank_cost_summary()
        assert cost[1] > cost[0]


# ------------------------------------------------------------- degradation
def _span(name, ts, dur, cat="train", **args):
    return {"name": name, "cat": cat, "ph": "X", "ts": float(ts), "dur": float(dur),
            "pid": 0, "tid": 0, "args": args}


def _session_trace(rank, epoch0, spans):
    events = [{"name": "process_name", "ph": "M", "pid": rank, "tid": 0,
               "args": {"name": f"deepspeed_tpu_torch rank {rank}"}}] + spans
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": {"rank": rank, "dropped_events": 0,
                         "clock_anchor": {"epoch_s": epoch0, "monotonic_s": 0.0}}}


def _steps(n, first_step=0):
    spans = []
    for i in range(n):
        spans.append(_span("data", i * 1e5, 2000, step=first_step + i))
        spans.append(_span("train_batch", i * 1e5 + 2000, 98_000, step=first_step + i))
    return spans


def _write(path, trace):
    path.write_text(json.dumps(trace))
    return str(path)


def _summary(ft):
    return (sorted(ft.by_rank), [tuple(m) for m in ft.collective_matches()],
            ft.straggler_table(), ft.clock_offsets(), list(ft.warnings))


def test_missing_rank_warns(tmp_path):
    paths = [_write(tmp_path / f"trace.rank{r}.json", _session_trace(r, 0.0, _steps(1)))
             for r in (0, 2)]
    port, ref = _both(paths)
    assert _summary(port) == _summary(ref)
    assert sorted(port.by_rank) == [0, 2]
    assert any("missing rank" in w and "1" in w for w in port.warnings)


def test_two_files_one_rank_is_an_error(tmp_path):
    from deepspeed_tpu.profiling import aggregate as jagg
    from deepspeed_tpu_torch.profiling import aggregate as tagg

    paths = [_write(tmp_path / n, _session_trace(0, 0.0, _steps(1))) for n in ("a.json",
                                                                              "b.json")]
    errors = []
    for mod in (tagg, jagg):
        with pytest.raises(ValueError, match="rank 0") as e:
            mod.FleetTrace.from_files(paths)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_restart_mid_trace_is_left_out_of_matching(tmp_path):
    comm = lambda ts: _span("all_reduce", ts, 1000, cat="comm", op="all_reduce", seq=0,
                            group="")
    paths = [_write(tmp_path / "trace.json",
                    _session_trace(0, 0.0, [comm(1000), comm(500_000)])),
             _write(tmp_path / "trace.rank1.json", _session_trace(1, 0.0, [comm(1000)]))]
    port, ref = _both(paths)
    assert _summary(port) == _summary(ref)
    assert port.collective_matches() == [] and port.straggler_table() == []
    assert any("more than once" in w for w in port.warnings)
    assert port.clock_offsets() == {0: 0.0, 1: 0.0}


def _cli_runs(args, capsys):
    from deepspeed_tpu.profiling import cli as jcli
    from deepspeed_tpu_torch.profiling import cli as tcli

    out = []
    for main in (tcli.main, jcli.main):
        rc = main(list(args))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


def test_empty_and_truncated_files(tmp_path, capsys):
    (tmp_path / "trace.rank1.json").write_text("")
    good = _write(tmp_path / "trace.json", _session_trace(0, 0.0, _steps(1)))
    torn = tmp_path / "trace.rank2.jsonl"
    with open(torn, "w") as f:
        f.write(json.dumps(_span("train_batch", 0, 1000, step=0)) + "\n")
        f.write('{"name": "tr')                # killed mid-append
    port, ref = _both([good, str(tmp_path / "trace.rank1.json"), str(torn)])
    assert _summary(port) == _summary(ref)
    assert sorted(port.by_rank) == [0, 2]
    assert any("empty trace" in w for w in port.warnings)
    assert any("torn" in w for w in port.warnings)
    (got, want) = _cli_runs(["merge", str(tmp_path)], capsys)
    assert got == want and got[0] == 0
    assert "empty trace" in got[2] and "torn" in got[2]


def test_merge_dir_scan_leaves_out_rotated_sessions(tmp_path, capsys):
    _write(tmp_path / "trace.session1.json", _session_trace(0, 0.0, _steps(1)))
    _write(tmp_path / "trace.json", _session_trace(0, 10.0, _steps(1, first_step=1)))
    (got, want) = _cli_runs(["merge", str(tmp_path), "--json"], capsys)
    assert got == want and got[0] == 0
    assert json.loads(got[1])["ranks"] == [0]


# ----------------------------------------------------- the comm layer's series
def test_timed_collective_series_and_straggler_spans_are_jax(tmp_path):
    """The comms logger's recent windows (skew, fastest-half excess, the
    straggler table) against JAX's ``CommsLogger`` on the same latencies,
    and one timed collective's record into a live session: the
    ``comm/*`` series, the ``cat="straggler"`` excess span past twice the
    window's baseline, and the ``cat="comm"`` span with its identity; a new
    session restarts the seq counters."""
    from deepspeed_tpu.comm.comm import CommsLogger as JLogger
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.runtime.config import TelemetryConfig

    lats = [1e-3, 1.1e-3, 0.9e-3, 1.05e-3, 0.95e-3, 1e-3, 1.2e-3, 0.8e-3, 5e-3, 1e-3]
    port, ref = comm.CommsLogger(), JLogger()
    for lat in lats:
        for lg in (port, ref):
            lg.append("all_reduce", "all_reduce", lat, 4096, n=2)
        assert port.window_skew("all_reduce", 4096) == ref.window_skew("all_reduce", 4096)
        for probe in (1e-3, 2.5e-3, 9e-3):
            assert port.straggler_excess("all_reduce", 4096, probe) == \
                ref.straggler_excess("all_reduce", 4096, probe)
    assert port.straggler_report() == ref.straggler_report()
    assert port.comms_dict == ref.comms_dict
    port.reset_straggler_windows()
    assert port.straggler_report() == [] and port.comms_dict
    log = port.log_all(print_log=False, show_straggler=True)
    assert log is port.comms_dict

    saved = comm.comms_logger
    comm.comms_logger = comm.CommsLogger()
    try:
        for n in range(2):
            telemetry.configure(TelemetryConfig(enabled=True, output_dir=str(tmp_path / str(n)),
                                                jsonl=False, prometheus=False))
            for lat in [1e-3] * comm.CommsLogger.STRAGGLER_MIN_SAMPLES + [10e-3]:
                comm.record_phase_span("gather_phase", lat, nbytes=512)
            events = telemetry.get_tracer().events
            spans = [e for e in events if e["cat"] == "comm"]
            assert [e["args"]["seq"] for e in spans] == list(range(9))     # from 0 each session
            assert {(e["args"]["op"], e["args"]["group"], e["args"]["bytes"])
                    for e in spans} == {("gather_phase", "world", 512)}
            (straggler,) = [e for e in events if e["cat"] == "straggler"]
            assert straggler["dur"] == pytest.approx(9e3, rel=1e-6)
            snap = {(r["name"], tuple(sorted(r["labels"].items()))): r
                    for r in telemetry.get_registry().snapshot()}
            assert snap[("comm/op_calls", (("op", "gather_phase"),))]["value"] == 9
            assert snap[("comm/op_bytes", (("op", "gather_phase"),))]["value"] == 9 * 512
            assert snap[("comm/straggler_excess_us", ())]["value"] == pytest.approx(9e3)
            assert snap[("comm/skew", (("op", "gather_phase"), ("size", "512")))]["value"] > 1
            telemetry.deconfigure()
            comm.comms_logger.reset_straggler_windows()
    finally:
        comm.comms_logger = saved
        telemetry.deconfigure()
