"""The port's ZeRO stages over two gloo ranks against the JAX package.

The partition plan is held against ``plan_sharding``'s choices on a
two-device mesh. Then two spawned processes train a small fp32 GPT-2 at
ZeRO stages 0–3 and gas 1 and 2 (stage 3 also under ``remat``), each rank
on its rows ``rank::2`` of the global batch, and the JAX engine trains the
same weights on the whole batch on the test conftest's 8-device CPU mesh:
losses, final params, global grad norm, LR and step counts within rtol 1e-4
(atol 1e-5 for params), the tolerance of ``test_engine_train_batch_matches
_jax``. The gas-2 batches carry a ``loss_mask`` whose token counts differ
between the ranks. The JAX engine's stages agree with one another to
rounding, so each gas has one JAX run (stage 3 for gas 1, 2 for gas 2)
that every port stage is held to. Besides: the world's mean stage-3
gradients of one microbatch, gathered whole from the shards, equal stage
0's (backward read gathered weights), and the engine's loader gives each
rank its ``rank::2`` rows of the JAX loader's batch. (The one-rank fp16
overflow is in ``test_torch_comm.py``.) In this process: LAMB over flat
units, as the engine runs it, against LAMB per tensor.

The ranks import no JAX: this module imports it inside its functions.
"""

import numpy as np
import pytest
import torch

from tests.torch_world import World

SMALL = dict(vocab_size=128, n_positions=32, n_embd=64, n_layer=2, n_head=2)
T, WORLD, STEPS = 32, 2, 3
THRESHOLD = 1000          # stage 3: the weights partitioned, biases and gains whole
CASES = [(0, 1), (1, 1), (2, 1), (3, 1), (0, 2), (1, 2), (2, 2), (3, 2)]
REMAT_CASE = (3, 2)       # also under remat
JAX_STAGE = {1: 3, 2: 2}  # the JAX run each gas is held to


def _config(stage, gas, **extra):
    return {"train_batch_size": 8 * gas, "gradient_accumulation_steps": gas,
            "steps_per_print": 0, "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-4,
                                                         "warmup_max_lr": 1e-3,
                                                         "warmup_num_steps": 2,
                                                         "warmup_type": "linear"}},
            "zero_optimization": {"stage": stage,
                                  "stage3_param_persistence_threshold": THRESHOLD},
            **extra}


def _batches():
    """The global batch of each gas; gas 2's mask keeps ~90% of the even
    rows' targets (rank 0) and ~30% of the odd rows' (rank 1)."""
    rng = np.random.RandomState(7)
    out = {}
    for gas in (1, 2):
        b = {"input_ids": rng.randint(0, SMALL["vocab_size"], size=(8 * gas, T)).astype(np.int32)}
        if gas == 2:
            keep = np.where(np.arange(8 * gas)[:, None] % 2 == 0, 0.9, 0.3)
            b["loss_mask"] = (rng.rand(8 * gas, T) < keep).astype(np.float32)
        out[gas] = b
    return out


def _samples():
    """Rows that name themselves: sample i is T copies of i."""
    return [{"input_ids": np.full(T, i, np.int32)} for i in range(32)]


# ------------------------------------------------------------ the ranks
def _port_engine(np_params, config, dtype=torch.float32, remat=False, **kw):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2

    model = gpt2.params_from_jax(np_params, gpt2.GPT2Config(**SMALL, remat=remat, dtype=dtype))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu", **kw)
    return engine


def _rows(batch, rank):
    return {k: v[rank::WORLD] for k, v in batch.items()}


def _ranks(rank, world, out_dir, np_params):
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import flatten_state

    batches, out = _batches(), {}
    for stage, gas in CASES + [("remat",) + REMAT_CASE[1:]]:
        remat = stage == "remat"
        engine = _port_engine(np_params, _config(REMAT_CASE[0] if remat else stage, gas),
                              remat=remat)
        b = _rows(batches[gas], rank)
        losses = [float(engine.train_batch(b)) for _ in range(STEPS)]
        state = flatten_state(engine)
        out[(stage, gas)] = {
            "losses": losses, "grad_norm": engine.get_global_grad_norm(),
            "lr": engine.get_lr()[0], "steps": engine.global_steps,
            "skipped": engine.skipped_steps,
            "params": {k[len("params/"):]: v.numpy().copy() for k, v in state.items()
                       if k.startswith("params/")}}

    # one microbatch's gradients, the world's mean, stage 3 against stage 0
    grads = {}
    for stage in (0, 3):
        engine = _port_engine(np_params, _config(stage, 1))
        engine.backward(engine.forward(_rows(batches[1], rank)))
        z = engine._zero
        grads[stage] = dict(zip(engine._param_names, z.to_host(z.reduced_grads(1))))
    out["grads"] = grads

    # the engine's loader: rank::world rows of each global batch
    engine = _port_engine(np_params, _config(1, 2), training_data=_samples())
    first = next(iter(engine.training_dataloader))["input_ids"]
    out["loader_rows"] = [int(r[0]) for r in first]
    out["local_batch"] = engine.train_micro_batch_size_per_gpu() * \
        engine.gradient_accumulation_steps()
    return out


def _weights(jax_model):
    """Seeded numpy weights in the JAX model's param tree (normal 0.02,
    unit gains, small random biases), without compiling its init."""
    import jax

    rng = np.random.RandomState(0)
    shapes = jax.eval_shape(jax_model.init_params, jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name.endswith("_g"):
            return np.ones(leaf.shape, np.float32)
        scale = 0.01 if name.endswith("_b") else 0.02
        return (scale * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and the JAX engine's, computed side by side."""
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu
    from deepspeed_tpu.models import gpt2 as jgpt2

    params = _weights(jgpt2.GPT2Model(jgpt2.GPT2Config(**SMALL, remat=False,
                                                       dtype=jnp.float32)))
    world = World(_ranks, WORLD, str(tmp_path_factory.mktemp("zero")),
                  args=(jax.tree.map(np.asarray, params),))
    ref, batches = {}, _batches()
    for gas, stage in JAX_STAGE.items():
        eng, *_ = deepspeed_tpu.initialize(
            model=jgpt2.GPT2Model(jgpt2.GPT2Config(**SMALL, remat=False, dtype=jnp.float32)),
            model_parameters=params, config=_config(stage, gas))
        ref[gas] = {"losses": [float(eng.train_batch(batches[gas])) for _ in range(STEPS)],
                    "grad_norm": eng.get_global_grad_norm(), "lr": eng.get_lr()[0],
                    "steps": eng.global_steps, "skipped": eng.skipped_steps,
                    "params": jax.tree.map(np.asarray, eng.state.params)}
    from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader

    ref["loader_rows"] = [int(r[0]) for r in next(iter(DeepSpeedDataLoader(
        _samples(), batch_size=_config(1, 2)["train_batch_size"])))["input_ids"]]
    return {"ranks": world.join(), "jax": ref}


def _jax_param(jp, name):
    if name.startswith("blocks."):
        _, n, key = name.split(".")
        return jp["blocks"][key][int(n)]
    return jp[name]


# ------------------------------------------------------------------ plan
@pytest.fixture(scope="module")
def jax_shapes():
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.models import gpt2 as jgpt2

    model = jgpt2.GPT2Model(jgpt2.GPT2Config(**SMALL, dtype=jnp.float32))
    return jax.eval_shape(model.init_params, jax.random.PRNGKey(0))


def _jax_plan(shapes, stage, threshold):
    import jax
    from jax.sharding import Mesh

    from deepspeed_tpu.runtime.zero.config import DeepSpeedZeroConfig as JZero
    from deepspeed_tpu.runtime.zero.partition import plan_sharding

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    plan = plan_sharding(shapes, mesh, JZero(stage=stage,
                                             stage3_param_persistence_threshold=threshold))

    def sharded(specs):
        flat = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        return {"/".join(str(getattr(k, "key", k)) for k in path):
                any("data" in (e if isinstance(e, tuple) else (e,)) for e in spec if e)
                for path, spec in flat}

    leaves = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    return (sharded(plan.param_specs), sharded(plan.master_specs), sharded(plan.grad_specs),
            leaves)


def _port_plan(stage, threshold):
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.runtime.zero.partition import plan_partition

    model = gpt2.GPT2Model(gpt2.GPT2Config(**SMALL, dtype=torch.float32))
    owner = {id(p): m for m, mod in model.named_modules() for p in mod.parameters(recurse=False)}
    return plan_partition([(n, tuple(p.shape), owner[id(p)])
                           for n, p in model.named_parameters()], stage, WORLD, threshold)


def _jax_key(name):
    return "blocks/" + name.split(".")[2] if name.startswith("blocks.") else name


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("threshold", [0, THRESHOLD, 5000, 100_000])
def test_partition_plan_matches_plan_sharding(jax_shapes, stage, threshold):
    """Which params, masters and gradients each stage partitions. The JAX
    package holds the threshold against the layer-stacked tensor, the port
    (as the reference) against each layer's: at 5000 the 4096-element
    ``proj_w`` of a layer is whole here and partitioned there (8192
    stacked); every other choice is the same."""
    jparam, jmaster, jgrad, jshapes = _jax_plan(jax_shapes, stage, threshold)
    plan = _port_plan(stage, threshold)
    for p in plan.params:
        key = _jax_key(p.name)
        stacked = int(np.prod(jshapes[key]))
        assert p.master_partitioned == jmaster[key] == (stage >= 1), p.name
        assert p.grad_partitioned == jgrad[key] == (stage >= 2), p.name
        assert p.partitioned == (stage == 3 and p.numel >= threshold), p.name
        assert jparam[key] == (stage == 3 and stacked >= threshold), p.name


def test_partition_plan_layout():
    """A unit per module (and at stage 3 the persistent one), padded to the
    world, each param's elements owned once across the ranks' shards; the
    report says what is partitioned."""
    from deepspeed_tpu_torch.runtime.zero.partition import ALIGN, partition_report

    for stage in range(4):
        plan = _port_plan(stage, THRESHOLD)
        assert all(u.length % (ALIGN * WORLD) == 0 and u.shard * WORLD == u.length
                   for u in plan.units)
        assert len(plan.units) == SMALL["n_layer"] + (1 if stage < 3 else 2)
        covered = {}
        for rank in range(WORLD):
            for i, u, s, e in plan.segments(rank):
                assert u == plan.params[i].unit and 0 <= s < e <= plan.units[u].shard
                covered[i] = covered.get(i, 0) + e - s
        assert covered == {i: p.numel for i, p in enumerate(plan.params)}
        assert f"ZeRO stage {stage}" in partition_report(plan)


# --------------------------------------------------------------- training
@pytest.mark.parametrize("stage,gas", CASES + [("remat", 2)])
def test_two_ranks_train_like_the_jax_engine(runs, stage, gas):
    ref = runs["jax"][gas]
    for rank, got in enumerate(runs["ranks"]):
        r = got[(stage, gas)]
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-4, err_msg=str(rank))
        assert r["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-4)
        assert r["lr"] == pytest.approx(ref["lr"], rel=1e-6)
        assert (r["steps"], r["skipped"]) == (ref["steps"], ref["skipped"]) == (STEPS, 0)
        for name, p in r["params"].items():
            np.testing.assert_allclose(p, _jax_param(ref["params"], name), rtol=1e-4,
                                       atol=1e-5, err_msg=f"rank {rank} {name}")
    a, b = (got[(stage, gas)] for got in runs["ranks"])
    assert a["losses"] == b["losses"]
    assert all(np.array_equal(a["params"][n], b["params"][n]) for n in a["params"])


def test_masked_token_counts_differ_between_the_ranks():
    """The premise of the gas-2 cases: each microbatch's ranks hold
    different numbers of valid targets."""
    mask = _batches()[2]["loss_mask"][:, 1:]
    for mb in (slice(0, 8), slice(8, 16)):
        counts = [mask[mb][r::WORLD].sum() for r in range(WORLD)]
        assert counts[0] > 2 * counts[1]


def test_stage3_gradients_equal_stage0(runs):
    for rank, got in enumerate(runs["ranks"]):
        g0, g3 = got["grads"][0], got["grads"][3]
        assert g0.keys() == g3.keys()
        for name in g0:
            torch.testing.assert_close(g3[name], g0[name], rtol=1e-5, atol=1e-7,
                                       msg=f"rank {rank} {name}")


def test_the_loader_gives_each_rank_its_rows(runs):
    """Rank r's first batch is rows r::2 of the JAX loader's first global
    batch, micro batch × gas of them."""
    for rank, got in enumerate(runs["ranks"]):
        assert got["loader_rows"] == runs["jax"]["loader_rows"][rank::WORLD]
        assert len(got["loader_rows"]) == got["local_batch"]


def test_lamb_over_units_matches_lamb_per_tensor():
    """LAMB's trust ratio needs each parameter's whole norms: over flat
    units, two ranks' shards of which hold pieces of one parameter, the
    summed squares give the per-tensor update (the sum over the group is
    the sum over these two shards here)."""
    from deepspeed_tpu_torch.ops.optimizers import fused_lamb
    from deepspeed_tpu_torch.runtime.zero.partition import plan_partition

    rng = np.random.RandomState(3)
    shapes = [(24, 16), (16,), (40, 8), (8,)]
    plan = plan_partition([(f"p{i}", s, "ab"[i // 2]) for i, s in enumerate(shapes)], 1, WORLD)
    params = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in shapes]
    grads = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in shapes]

    def units(tensors):
        out = []
        for unit in plan.units:
            flat = torch.zeros(unit.length)
            for i in unit.params:
                p = plan.params[i]
                flat[p.offset:p.offset + p.numel] = tensors[i].flatten()
            out.append(flat)
        return out

    opt = fused_lamb(lr=1e-2, weight_decay=0.01)
    ref = [p.clone() for p in params]
    ref_state = opt.init(ref)
    flat = units(params)
    state = opt.init(flat)
    segments = [(i, u, s + r * plan.units[u].shard, e + r * plan.units[u].shard)
                for r in range(WORLD) for i, u, s, e in plan.segments(r)]
    for _ in range(2):
        ref_state = opt.update(grads, ref_state, ref)
        state = opt.update(units(grads), state, flat, segments=segments,
                           num_params=len(shapes))
    for got, want in zip(flat, units(ref)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
