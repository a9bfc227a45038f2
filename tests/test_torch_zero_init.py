"""zero.Init and TiledLinear in the port, on the CPU.

``zero.materialize`` builds a model's parameters unit by unit in their ZeRO
placement from the model's random draws: the values equal the whole-tree
``init_params`` from the same seed, bit for bit, at every stage and with the
params in host memory; the engine's own init (weights not loaded) goes the
same way and equals an engine given the whole-tree weights; a materialized
model is adopted by ``initialize`` under the same plan and refused under
another. Over two gloo ranks at stage 3, with draws cut into small pieces,
each rank keeps its shards of the whole-tree values, and no allocation of
either rank, in ``materialize`` or in the engine's init, reaches a whole
partitioned unit (the profiler's allocation sizes). The JAX
``TestZeroInit`` cases (``tests/unit/test_runtime_utils.py``) carry over.
``TiledLinear`` and ``tiled_matmul`` match the JAX ones with copied weights
(1e-6) and the dense product, forward and backward.

The ranks import no JAX: this module imports it inside its functions.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime import zero
from deepspeed_tpu_torch.runtime.zero.state import PARAMS
from tests.torch_world import World

# the embedding unit (34,816 elements) larger than a block unit's shard
# over two ranks (24,576), so an allocation below the largest shard is
# below every whole unit
SMALL = dict(vocab_size=512, n_positions=32, n_embd=64, n_layer=2, n_head=2, remat=False,
             dtype=torch.float32)
THRESHOLD, PIECE = 1000, 2048


def _zero(stage, **extra):
    return {"zero_optimization": {"stage": stage,
                                  "stage3_param_persistence_threshold": THRESHOLD, **extra}}


def _whole_tree(seed):
    return tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL)).init_params(
        torch.Generator().manual_seed(seed)).state_dict()


def _engine(config_zero, model, **kw):
    cfg = {"train_batch_size": 4, "steps_per_print": 0, "seed": 7,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, **config_zero}
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu", **kw)
    return engine


# ------------------------------------------------------------ the ranks
def _ranks(rank, world, out_dir):
    from torch.profiler import ProfilerActivity, profile

    tgpt2.INIT_CHUNK = PIECE
    out = {}
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL))
        with zero.Init(config=_zero(3), device="cpu"):
            state = zero.materialize(model, torch.Generator().manual_seed(3))
        engine = _engine(_zero(3), tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL)))
    out["largest_allocation"] = max(e.self_cpu_memory_usage for e in prof.events())
    units = [u for u in state.plan.units if u.partitioned]
    out["whole_units"] = [4 * u.length for u in units]
    out["largest_shard"] = max(4 * u.shard for u in units)
    out["shards"] = {u: state.parts[u].clone() for u in state.parts}
    out["engine_shards"] = {u: engine._zero.parts[u].clone() for u in engine._zero.parts}
    out["plan"] = state.plan
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return World(_ranks, 2, str(tmp_path_factory.mktemp("zero_init"))).join()


def test_two_ranks_keep_their_shards_and_never_a_whole_unit(ranks):
    """Values: each rank's shard of each unit is its slice of the whole-tree
    build (seed 3 for materialize, the engine's seed 7 for the engine)."""
    for seed, key in ((3, "shards"), (7, "engine_shards")):
        tgpt2.INIT_CHUNK, old = PIECE, tgpt2.INIT_CHUNK
        try:
            tree = _whole_tree(seed)
        finally:
            tgpt2.INIT_CHUNK = old
        for rank, out in enumerate(ranks):
            plan = out["plan"]
            for u, shard in out[key].items():
                unit = plan.units[u]
                whole = torch.zeros(unit.length)
                for i in unit.params:
                    p = plan.params[i]
                    whole[p.offset:p.offset + p.numel] = tree[p.name].reshape(-1)
                assert torch.equal(shard, whole[rank * unit.shard:(rank + 1) * unit.shard]), \
                    (key, rank, unit.name)
    for out in ranks:
        assert out["largest_allocation"] <= out["largest_shard"] < min(out["whole_units"])


# --------------------------------------------------------------- values
@pytest.mark.parametrize("stage,host", [(0, False), (1, True), (2, False), (3, False),
                                        (3, True)])
def test_materialize_equals_the_whole_tree(monkeypatch, stage, host):
    monkeypatch.setattr(tgpt2, "INIT_CHUNK", PIECE)
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL))
    extra = {"offload_param": {"device": "cpu"}} if host else {}
    with zero.Init(config=_zero(stage, **extra), device="cpu"):
        state = zero.materialize(model.param_chunks, torch.Generator().manual_seed(3))
    assert any(state.fetched) == (stage == 3 or host)
    assert state.fp32 == [None] * len(state.plan.units)        # dropped
    tree = _whole_tree(3)
    names = [p.name for p in state.plan.params]
    for name, value in zip(names, state.to_host(PARAMS)):
        assert torch.equal(value, tree[name]), name
    ids = torch.randint(0, SMALL["vocab_size"], (2, 16), generator=torch.Generator().manual_seed(0))
    reference = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL))
    reference.load_state_dict(tree, assign=True)
    assert torch.equal(model.loss(ids), reference.loss(ids))     # gathers through the state


@pytest.mark.parametrize("stage", [0, 3])
def test_engine_init_in_place_equals_given_weights(stage):
    built = _engine(_zero(stage), tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL)))
    given = _engine(_zero(stage), tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL)),
                    model_parameters=_whole_tree(7))
    a, b = built.module_state_dict(), given.module_state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_engine_adopts_a_materialized_model():
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL))
    with zero.Init(config=_zero(3), device="cpu"):
        zero.materialize(model, torch.Generator().manual_seed(3))
    engine = _engine(_zero(3), model)
    tree = _whole_tree(3)
    assert all(torch.equal(v, tree[k]) for k, v in engine.module_state_dict().items())
    other = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL))
    with zero.Init(config=_zero(3), device="cpu"):
        zero.materialize(other, torch.Generator().manual_seed(3))
    with pytest.raises(ValueError, match="another ZeRO plan"):
        _engine(_zero(2), other)


# ------------------------------------------ the JAX TestZeroInit cases
def test_materialize_partitions_params():
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL))
    with zero.Init(config={"zero_optimization": {"stage": 3,
                                                 "stage3_param_persistence_threshold": 0}},
                   device="cpu") as zi:
        state = zi.materialize(model, torch.Generator().manual_seed(0))
    assert all(state.fetched)                        # every unit partitioned
    assert all(p.numel() == 0 for p in model.parameters())
    assert state.plan.params[0].shape == (SMALL["vocab_size"], SMALL["n_embd"])


def test_disabled_passthrough():
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL))
    with zero.Init(enabled=False) as zi:
        out = zi.materialize(model.init_params, torch.Generator().manual_seed(0))
    assert out is model and model.blocks[0].qkv_w.shape == (64, 192)


def test_materialize_outside_context_raises():
    with pytest.raises(RuntimeError, match="active"):
        zero.materialize(lambda: {})


# ----------------------------------------------------------- TiledLinear
def test_tiled_linear_matches_jax_and_dense():
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.runtime.zero.tiling import TiledLinear as JTiled
    from deepspeed_tpu.runtime.zero.tiling import tiled_matmul as jtiled

    x = np.random.RandomState(0).normal(size=(4, 5, 32)).astype(np.float32)
    jlin = JTiled(32, 48, in_splits=4, out_splits=3)
    jp = jax.tree.map(np.asarray, jlin.init_params(jax.random.PRNGKey(1)))
    want = np.asarray(jlin.apply(jp, jnp.asarray(x)))
    lin = zero.TiledLinear(32, 48, in_splits=4, out_splits=3)
    with torch.no_grad():
        lin.w.copy_(torch.tensor(jp["w"]))
        lin.b.copy_(torch.tensor(jp["b"]))
    xt = torch.from_numpy(x).requires_grad_()
    got = lin(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        zero.tiled_matmul(torch.from_numpy(x), lin.w.detach(), 2, 4).numpy(),
        np.asarray(jtiled(jnp.asarray(x), jnp.asarray(jp["w"]), 2, 4)), rtol=1e-6, atol=1e-6)
    got.square().sum().backward()
    xd = torch.from_numpy(x).requires_grad_()
    dense = xd @ lin.w + lin.b
    dense.square().sum().backward()
    torch.testing.assert_close(got, dense, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xt.grad, xd.grad, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        zero.TiledLinear(30, 48, in_splits=4)
