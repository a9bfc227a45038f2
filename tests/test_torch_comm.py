"""The port's communication layer over two gloo ranks against the JAX package.

Two spawned processes run every collective of ``deepspeed_tpu_torch.comm``
on the same seeded numpy inputs (rank r takes slot r), and the JAX
package's eager collectives run over a 2-device mesh built from the test
conftest's CPU devices, with the inputs stacked on the group dim as that
API takes them: each rank's result equals its slot of the JAX result
(rtol 1e-6; two addends leave no room for reordering). Where the JAX
package has no eager form (``scatter``, ``send``/``recv``, the host-side
objects, the bitwise ops) the result is held to numpy's. ``ppermute`` is
held to ``jax.lax.ppermute`` inside a ``shard_map``.

The functional ``reduce_scatter`` (each rank's whole tensor in, this
rank's shard of the sum out) is held to numpy's sum-then-split of the
ranks' inputs, along each dimension; ``monitored_barrier`` without a
timeout takes the default of ``set_default_barrier_timeout``, whose
manual-versus-config source rule is the JAX package's; the benchmark's
rows (``comm/benchmark.py``) on the two ranks, and its message sizes and
bus factors for groups of 2, 4 and 8, are the JAX tool's.

Also: ``ProcessTopology`` and ``_busbw_factor`` against the JAX package's
in this process, the ``CommsLogger`` records against the JAX logger's on
the same calls, its counts and sizes on the ranks (the engine's collectives
of a ZeRO-2 step among them), ``log_dist`` on the real rank, the set-up's
refusals, and the fp16 overflow verdict: an inf in one rank's rows makes
the MAX all-reduce skip the step on both ranks, as the JAX engine skips it
on the whole batch.

The ranks import no JAX: this module imports it inside its functions.
"""

import logging

import numpy as np
import pytest
import torch

from tests.torch_world import World

WORLD = 2
X_SHAPE = (4, 3)
OPS = ("sum", "max", "min", "avg", "product")
SMALL = dict(vocab_size=128, n_positions=32, n_embd=64, n_layer=2, n_head=2)
FP16_CONFIG = {"train_batch_size": 8, "steps_per_print": 0,
               "fp16": {"enabled": True, "initial_scale_power": 4, "hysteresis": 1},
               "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}


def _inputs():
    rng = np.random.RandomState(11)
    return {"x": rng.randn(WORLD, *X_SHAPE).astype(np.float32),
            "y": rng.randn(WORLD, 6).astype(np.float32),
            "bits": rng.randint(0, 256, size=(WORLD, 5)).astype(np.int64),
            "z": rng.randn(WORLD, 4, 6).astype(np.float32)}


def _fp16_batch():
    """A batch whose rank-1 rows hold an inf in the loss mask."""
    ids = np.random.RandomState(5).randint(0, SMALL["vocab_size"], size=(8, 32)).astype(np.int32)
    mask = np.ones((8, 32), np.float32)
    mask[3, 10] = np.inf
    return {"input_ids": ids, "loss_mask": mask}


# ------------------------------------------------------------ the ranks
def _collectives(rank, inp):
    from deepspeed_tpu_torch import comm

    x, y = torch.from_numpy(inp["x"][rank]), torch.from_numpy(inp["y"][rank])
    out = {f"all_reduce_{op}": comm.all_reduce(x.clone(), op=op).numpy() for op in OPS}
    for op in ("band", "bor", "bxor"):
        out[f"all_reduce_{op}"] = comm.all_reduce(
            torch.from_numpy(inp["bits"][rank]).clone(), op=op).numpy()
    out["all_gather_into_tensor"] = comm.all_gather_into_tensor(
        x.new_empty(WORLD * X_SHAPE[0], X_SHAPE[1]), x).numpy()
    out["all_gather"] = np.stack([t.numpy() for t in comm.all_gather(
        [torch.empty_like(x) for _ in range(WORLD)], x)])
    out["reduce_scatter_tensor"] = comm.reduce_scatter_tensor(
        x.new_empty(X_SHAPE[0] // WORLD, X_SHAPE[1]), x).numpy()
    out["reduce_scatter_tensor_avg"] = comm.reduce_scatter_tensor(
        x.new_empty(X_SHAPE[0] // WORLD, X_SHAPE[1]), x, op="avg").numpy()
    out["all_to_all_single"] = comm.all_to_all_single(torch.empty_like(x), x).numpy()
    out["broadcast"] = comm.broadcast(x.clone(), src=1).numpy()
    out["reduce"] = comm.reduce(x.clone(), dst=0).numpy()
    gathered = [torch.empty_like(x) for _ in range(WORLD)] if rank == 0 else None
    comm.gather(x, gathered, dst=0)
    out["gather"] = None if gathered is None else np.stack([t.numpy() for t in gathered])
    out["scatter"] = comm.scatter(torch.empty(3), [torch.full((3,), 10.0 + r)
                                                   for r in range(WORLD)], src=0).numpy()
    out["all_gather_coalesced"] = [t.numpy() for t in comm.all_gather_coalesced([x, y])]
    out["all_reduce_coalesced"] = [t.numpy() for t in comm.all_reduce_coalesced(
        [x.clone(), y.clone()], op="max")]
    out["ppermute"] = comm.ppermute(x, [(0, 1), (1, 0)]).numpy()
    out["ppermute_one_way"] = comm.ppermute(x, [(0, 1)]).numpy()
    if rank == 0:
        comm.send(x, dst=1)
        out["recv"] = None
    else:
        out["recv"] = comm.recv(torch.empty_like(x), src=0).numpy()
    out["allgather_host"] = comm.allgather_host(np.array([rank, 10 * rank]))
    out["broadcast_object_list"] = comm.broadcast_object_list(
        [{"from": rank}, f"rank{rank}"], src=1)
    group = comm.new_group([0, 1])
    out["new_group_sum"] = comm.all_reduce(x.clone(), group=group).numpy()
    out["global_rank"] = comm.get_global_rank(group, 1)
    comm.barrier()
    comm.monitored_barrier(timeout=10, wait_all_ranks=True)
    out["rank"] = (comm.get_rank(), comm.get_world_size(), comm.get_local_rank())
    return out


REDUCE_SCATTER_CASES = {"dim0": dict(scatter_dimension=0), "dim1": dict(scatter_dimension=1),
                        "dim_last_avg": dict(scatter_dimension=-1, op="avg")}
SWEEP = dict(min_bytes=1 << 10, max_bytes=1 << 12, trials=1, warmups=1)


def _functional(rank, inp):
    """The functional reduce_scatter, the barrier's default deadline as the
    barrier passes it on, and the benchmark's rows."""
    import torch.distributed as tdist

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm.benchmark import run_sweep

    z = torch.from_numpy(inp["z"][rank])
    out = {name: comm.reduce_scatter(z, **kw).numpy()
           for name, kw in REDUCE_SCATTER_CASES.items()}
    out["untiled"] = comm.reduce_scatter(z[:WORLD], tiled=False).numpy()
    seen = []
    real = tdist.monitored_barrier

    def spy(*args, **kwargs):
        seen.append(kwargs.get("timeout"))
        return real(*args, **kwargs)

    tdist.monitored_barrier = spy
    try:
        comm.set_default_barrier_timeout(30)
        comm.monitored_barrier()
        comm.monitored_barrier(timeout=20)
        comm.set_default_barrier_timeout(None)
        comm.monitored_barrier()
    finally:
        tdist.monitored_barrier = real
    out["barrier_timeouts"] = [None if t is None else t.total_seconds() for t in seen]
    out["sweep"] = [row for op in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
                    for row in run_sweep(op, dtype=torch.float32, device="cpu", **SWEEP)]
    return out


def _logged(rank):
    """CommsLogger counts and sizes: fixed calls, then one ZeRO-2 step."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import gpt2

    comm.configure(enabled=True)
    x = torch.ones(16)
    comm.all_reduce(x.clone())
    comm.all_reduce(x.clone(), op="avg")
    comm.all_gather_into_tensor(torch.empty(16), torch.ones(8))
    comm.reduce_scatter_tensor(torch.empty(4), torch.ones(8))
    calls = comm.comm.comms_logger.totals()
    comm.configure(enabled=False)

    model = gpt2.GPT2Model(gpt2.GPT2Config(**SMALL, remat=False, dtype=torch.float32))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, device="cpu", config={
        "train_batch_size": 4, "steps_per_print": 0, "zero_optimization": {"stage": 2},
        "optimizer": {"type": "AdamW", "params": {}}, "comms_logger": {"enabled": True}})
    comm.comm.comms_logger.comms_dict.clear()
    engine.train_batch({"input_ids": torch.zeros(2, 32, dtype=torch.long)})
    step = comm.comm.comms_logger.totals()
    summary = comm.log_summary()
    comm.configure(enabled=False)
    return {"calls": calls, "step": step, "flat_numel": engine._plan.numel,
            "units": len(engine._plan.units), "summary_ops": sorted(summary)}


def _log_dist_records(rank):
    from deepspeed_tpu_torch.utils.logging import log_dist, logger

    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    keep = Keep()
    logger.addHandler(keep)
    try:
        log_dist("to rank 0", ranks=[0])
        log_dist("to rank 1", ranks=[1])
        log_dist("to all")
    finally:
        logger.removeHandler(keep)
    return seen


def _fp16_overflow(rank, np_fp16_params):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2

    model = gpt2.params_from_jax(np_fp16_params,
                                 gpt2.GPT2Config(**SMALL, remat=False, dtype=torch.float16))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, device="cpu", config=dict(FP16_CONFIG, zero_optimization={"stage": 2}))
    before = {n: t.clone() for n, t in engine.module_state_dict().items()}
    engine.train_batch({k: v[rank::WORLD] for k, v in _fp16_batch().items()})
    after = engine.module_state_dict()
    return {"skipped": engine.skipped_steps, "steps": engine.global_steps,
            "scale": engine.get_loss_scale(),
            "unchanged": all(torch.equal(t, before[n]) for n, t in after.items()),
            "params": {n: t.numpy() for n, t in after.items()}}


def _ranks(rank, world, out_dir, inp, np_fp16_params):
    from deepspeed_tpu_torch.parallel.topology import ParallelGrid

    grid = ParallelGrid()
    return {"collectives": _collectives(rank, inp), "functional": _functional(rank, inp),
            "logged": _logged(rank),
            "log_dist": _log_dist_records(rank), "fp16": _fp16_overflow(rank, np_fp16_params),
            "grid": (grid.get_data_parallel_world_size(), grid.get_data_parallel_rank(),
                     grid.get_model_parallel_world_size())}


# -------------------------------------------------------- the JAX package
def _jax_collectives(inp):
    """The JAX package's eager collectives over a 2-device mesh, inputs
    stacked on the group dim; the conftest restores the global mesh."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from deepspeed_tpu.comm import comm as jcomm

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    jcomm.init_distributed(mesh=mesh, verbose=False)
    X, Y = inp["x"], inp["y"]
    np_ = lambda a: np.asarray(a)
    ref = {f"all_reduce_{op}": np_(jcomm.all_reduce(X, op=op)) for op in OPS}
    ref["all_gather_into_tensor"] = np_(jcomm.all_gather_into_tensor(None, X)) \
        .reshape(WORLD, WORLD * X_SHAPE[0], X_SHAPE[1])
    ref["all_gather"] = np_(jcomm.all_gather(X))
    ref["reduce_scatter_tensor"] = np_(jcomm.reduce_scatter_tensor(None, X))
    ref["all_to_all_single"] = np_(jcomm.all_to_all_single(X))
    ref["broadcast"] = np_(jcomm.broadcast(X, src=1))
    ref["reduce"] = np_(jcomm.reduce(X, dst=0))
    ref["gather"] = np_(jcomm.gather(X, dst=0))
    ref["all_gather_coalesced"] = [np_(a).reshape(WORLD, -1, *a.shape[3:])
                                   for a in jcomm.all_gather_coalesced([X, Y])]
    ref["all_reduce_coalesced"] = [np_(a) for a in jcomm.all_reduce_coalesced([X, Y], op="max")]
    ref["new_group_sum"] = np_(jcomm.all_reduce(X, group="data"))
    spec = P("data")
    ref["ppermute"] = np_(jax.shard_map(lambda a: jax.lax.ppermute(a, "data", [(0, 1), (1, 0)]),
                                        mesh=mesh, in_specs=spec, out_specs=spec)(X))
    ref["ppermute_one_way"] = np_(jax.shard_map(lambda a: jax.lax.ppermute(a, "data", [(0, 1)]),
                                                mesh=mesh, in_specs=spec, out_specs=spec)(X))
    for missing in (lambda: jcomm.scatter(X), lambda: jcomm.send(X, 1),
                    lambda: jcomm.recv(X, 0)):
        with pytest.raises(NotImplementedError):
            missing()
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu
    from deepspeed_tpu.models import gpt2 as jgpt2

    inp = _inputs()
    fp16_params = jax.tree.map(
        lambda a: np.asarray(a).astype(np.float16),
        jgpt2.GPT2Model(jgpt2.GPT2Config(**SMALL, remat=False, dtype=jnp.float32))
        .init_params(jax.random.PRNGKey(0)))
    world = World(_ranks, WORLD, str(tmp_path_factory.mktemp("comm")),
                  args=(inp, fp16_params))
    ref = _jax_collectives(inp)
    eng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.GPT2Model(jgpt2.GPT2Config(**SMALL, remat=False, dtype=jnp.float16)),
        model_parameters=jax.tree.map(jnp.asarray, fp16_params), config=dict(FP16_CONFIG))
    eng.train_batch(_fp16_batch())
    ref["fp16"] = {"skipped": eng.skipped_steps, "steps": eng.global_steps,
                   "scale": eng.get_loss_scale(),
                   "params": jax.tree.map(np.asarray, eng.state.params)}
    return {"ranks": world.join(), "jax": ref, "inputs": inp}


# ----------------------------------------------------------------- tests
JAX_HELD = [f"all_reduce_{op}" for op in OPS] + [
    "all_gather_into_tensor", "all_gather", "reduce_scatter_tensor", "all_to_all_single",
    "broadcast", "new_group_sum", "ppermute", "ppermute_one_way"]


@pytest.mark.parametrize("name", JAX_HELD)
def test_collective_matches_jax(runs, name):
    for rank, got in enumerate(runs["ranks"]):
        np.testing.assert_allclose(got["collectives"][name], runs["jax"][name][rank],
                                   rtol=1e-6, err_msg=f"{name} rank {rank}")


def test_rooted_and_coalesced_collectives_match_jax(runs):
    """reduce and gather land on the root (the JAX package lowers them to
    all-reduce and all-gather, whose slot 0 is the root's); the coalesced
    forms equal their one-tensor forms."""
    ref = runs["jax"]
    root = runs["ranks"][0]["collectives"]
    np.testing.assert_allclose(root["reduce"], ref["reduce"][0], rtol=1e-6)
    np.testing.assert_allclose(root["gather"], ref["gather"][0], rtol=1e-6)
    assert runs["ranks"][1]["collectives"]["gather"] is None
    for rank, got in enumerate(runs["ranks"]):
        c = got["collectives"]
        for a, b in zip(c["all_gather_coalesced"], ref["all_gather_coalesced"]):
            np.testing.assert_allclose(a, b[rank].reshape(a.shape), rtol=1e-6)
        for a, b in zip(c["all_reduce_coalesced"], ref["all_reduce_coalesced"]):
            np.testing.assert_allclose(a, b[rank], rtol=1e-6)


def test_collectives_without_a_jax_eager_form_match_numpy(runs):
    x, bits = runs["inputs"]["x"], runs["inputs"]["bits"]
    for rank, got in enumerate(runs["ranks"]):
        c = got["collectives"]
        np.testing.assert_array_equal(c["all_reduce_band"], bits[0] & bits[1])
        np.testing.assert_array_equal(c["all_reduce_bor"], bits[0] | bits[1])
        np.testing.assert_array_equal(c["all_reduce_bxor"], bits[0] ^ bits[1])
        np.testing.assert_allclose(c["reduce_scatter_tensor_avg"],
                                   x.mean(0)[rank * 2:(rank + 1) * 2], rtol=1e-6)
        np.testing.assert_array_equal(c["scatter"], np.full(3, 10.0 + rank))
        np.testing.assert_array_equal(c["allgather_host"], [[0, 0], [1, 10]])
        assert c["broadcast_object_list"] == [{"from": 1}, "rank1"]
        assert c["global_rank"] == 1 and c["rank"] == (rank, WORLD, rank)
    np.testing.assert_array_equal(runs["ranks"][1]["collectives"]["recv"], x[0])


def test_functional_reduce_scatter_is_the_sum_split(runs):
    total = runs["inputs"]["z"].sum(0)                       # (4, 6)
    for rank, got in enumerate(runs["ranks"]):
        f = got["functional"]
        np.testing.assert_allclose(f["dim0"], np.split(total, WORLD, 0)[rank], rtol=1e-6)
        np.testing.assert_allclose(f["dim1"], np.split(total, WORLD, 1)[rank], rtol=1e-6)
        np.testing.assert_allclose(f["dim_last_avg"], np.split(total / WORLD, WORLD, 1)[rank],
                                   rtol=1e-6)
        np.testing.assert_allclose(f["untiled"], total[rank], rtol=1e-6)


def test_monitored_barrier_takes_the_default_timeout(runs):
    for got in runs["ranks"]:
        assert got["functional"]["barrier_timeouts"] == [30.0, 20.0, None]


def test_barrier_timeout_source_rule_matches_jax():
    """A manual default survives an engine's clear, a config one does not;
    a non-positive one is refused: the same state as the JAX module's
    after each call."""
    from deepspeed_tpu.comm import comm as jcomm

    from deepspeed_tpu_torch.comm import comm as tcomm

    steps = [("set", 5.0, "manual"), ("clear",), ("set", 7.0, "config"), ("clear",),
             ("set", 3.0, "config"), ("set", None, "manual"), ("clear",), ("set", -1.0, "manual")]
    try:
        for step in steps:
            states = []
            for mod in (jcomm, tcomm):
                try:
                    if step[0] == "set":
                        mod.set_default_barrier_timeout(step[1], source=step[2])
                    else:
                        mod.clear_config_barrier_timeout()
                    err = None
                except ValueError as e:
                    err = str(e)
                states.append((mod._default_barrier_timeout,
                               mod._default_barrier_timeout_source, err))
            assert states[0] == states[1], step
    finally:
        for mod in (jcomm, tcomm):
            mod.set_default_barrier_timeout(None)


def test_benchmark_rows_and_bus_factors_match_jax(runs, monkeypatch):
    """The JAX tool over meshes of 2, 4 and 8 of the conftest's CPU devices:
    its rows' ops and bytes are the port's message sizes, and its bus
    factor is the port's; the two gloo ranks' rows are the 2-device ones.
    The JAX tool takes its world from ``jax.device_count()`` (all 8), so
    here it reads the size of the mesh it runs over instead."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from deepspeed_tpu.comm import benchmark as jbench
    from deepspeed_tpu.comm import comm as jcomm

    from deepspeed_tpu_torch.comm import benchmark as tbench

    ops = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
    for n in (2, 4, 8):
        jcomm.init_distributed(mesh=Mesh(np.array(jax.devices()[:n]), ("data",)),
                               verbose=False)
        monkeypatch.setattr(jcomm, "get_world_size", lambda group=None, n=n: n)
        rows = [r for op in ops for r in jbench.run_sweep(op, dtype=jnp.float32, **SWEEP)]
        sizes = tbench.message_sizes(SWEEP["min_bytes"], SWEEP["max_bytes"], 4, n)
        assert [(r["op"], r["bytes"]) for r in rows] == \
            [(op, b) for op in ops for _, b in sizes], n
        for op in ops:
            assert tbench._bus_factor(op, n) == jbench._bus_factor(op, n), (op, n)
        if n == WORLD:
            for got in runs["ranks"]:
                sweep = got["functional"]["sweep"]
                assert [(r["op"], r["bytes"]) for r in sweep] == \
                    [(r["op"], r["bytes"]) for r in rows]
                for r in sweep:
                    assert r["latency_us"] > 0
                    assert r["busbw_gbps"] == pytest.approx(
                        r["algbw_gbps"] * jbench._bus_factor(r["op"], n))


def test_process_topology_and_busbw_match_jax():
    from deepspeed_tpu.comm.comm import _busbw_factor as jbusbw
    from deepspeed_tpu.parallel.topology import ProcessTopology as JTopo

    from deepspeed_tpu_torch.comm.comm import _busbw_factor
    from deepspeed_tpu_torch.parallel.topology import ProcessTopology

    axes, dims = ["pipe", "data", "tensor"], [2, 3, 2]
    j, t = JTopo(axes, dims), ProcessTopology(axes, dims)
    assert t.world_size() == j.world_size() == 12
    for rank in range(12):
        assert tuple(t.get_coord(rank)) == tuple(j.get_coord(rank))
        assert t.get_rank(**t.get_coord(rank)._asdict()) == rank
        assert t.get_rank_repr(rank) == j.get_rank_repr(rank)
    for axis in axes + ["expert"]:
        assert t.get_axis_comm_lists(axis) == j.get_axis_comm_lists(axis)
        assert t.get_dim(axis) == j.get_dim(axis)
    assert t.filter_match(pipe=1, tensor=0) == j.filter_match(pipe=1, tensor=0)
    for op in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
               "all_to_all_single", "broadcast", "inference_all_reduce"):
        for n in range(1, 9):
            assert _busbw_factor(op, n) == jbusbw(op, n), (op, n)


def test_comms_logger_records_like_jax():
    from deepspeed_tpu.comm.comm import CommsLogger as JLogger

    from deepspeed_tpu_torch.comm.comm import CommsLogger

    j, t = JLogger(), CommsLogger()
    for args in (("all_reduce", "all_reduce", 0.002, 1024, 4),
                 ("all_reduce", "grads", 0.004, 1024, 4),
                 ("all_gather_into_tensor", "all_gather_into_tensor", 0.001, 4096, 8),
                 ("broadcast", "broadcast", 0.0, 64, 2)):
        j.append(*args)
        t.append(*args)
    assert t.comms_dict == j.comms_dict
    assert t.totals()["all_reduce"] == {"calls": 2, "bytes": 2048,
                                        "seconds": pytest.approx(0.006)}


def test_comms_logger_counts_the_ranks_collectives(runs):
    """Fixed calls, then a ZeRO-2 fp32 step at world 2: the loss mean and
    the norm's all-reduce, and for each unit (a module's parameters, flat)
    one reduce-scatter of its fp32 gradient and one all-gather of its
    updated params."""
    for got in runs["ranks"]:
        log = got["logged"]
        assert log["calls"] == {
            "all_reduce": {"calls": 2, "bytes": 128, "seconds": pytest.approx(
                log["calls"]["all_reduce"]["seconds"])},
            "all_gather_into_tensor": {"calls": 1, "bytes": 64, "seconds": pytest.approx(
                log["calls"]["all_gather_into_tensor"]["seconds"])},
            "reduce_scatter_tensor": {"calls": 1, "bytes": 32, "seconds": pytest.approx(
                log["calls"]["reduce_scatter_tensor"]["seconds"])}}
        step = {op: (v["calls"], v["bytes"]) for op, v in log["step"].items()}
        flat, units = 4 * log["flat_numel"], log["units"]
        assert units == SMALL["n_layer"] + 1
        assert step == {"all_reduce": (2, 8), "reduce_scatter_tensor": (units, flat),
                        "all_gather_into_tensor": (units, flat)}
        assert log["summary_ops"] == sorted(step)


def test_log_dist_uses_the_real_rank(runs):
    for rank, got in enumerate(runs["ranks"]):
        assert got["log_dist"] == [f"[Rank {rank}] to rank {rank}", f"[Rank {rank}] to all"]


def test_the_grid_is_the_data_parallel_world(runs):
    for rank, got in enumerate(runs["ranks"]):
        assert got["grid"] == (WORLD, rank, 1)


def test_one_rank_fp16_overflow_skips_the_step_on_both(runs):
    """Both ranks skip, keep their params (equal to the JAX engine's, bit
    for bit), advance the step and halve the scale, as the JAX engine does
    on the whole batch."""
    ref = runs["jax"]["fp16"]
    assert (ref["skipped"], ref["steps"], ref["scale"]) == (1, 1, 8.0)
    for got in runs["ranks"]:
        f = got["fp16"]
        assert (f["skipped"], f["steps"], f["scale"], f["unchanged"]) == (1, 1, 8.0, True)
        for name, p in f["params"].items():
            key = name.split(".")
            want = ref["params"]["blocks"][key[2]][int(key[1])] if name.startswith("blocks.") \
                else ref["params"][name]
            np.testing.assert_array_equal(p, want, err_msg=name)


def test_setup_refuses_what_it_cannot_run(monkeypatch):
    from deepspeed_tpu_torch import comm

    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not comm.is_initialized()
    with pytest.raises(ValueError, match="gloo there and falls back to nothing"):
        comm.init_distributed(device="cpu", dist_backend="nccl")
    with pytest.raises(ValueError, match="needs init_method"):
        comm.init_distributed(device="cpu", rank=0, world_size=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            comm.init_distributed()
    assert not comm.is_initialized()
    with pytest.raises(ValueError, match="async_op=False"):
        comm.comm._average(torch.ones(2), "avg", None, async_op=True)
