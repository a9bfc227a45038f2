"""Expert parallelism over gloo ranks against the JAX one-program engine.

The JAX engine runs a step as one program over the global micro-batch: its
gates route every token together (the capacity of the global token count,
the queues in global token order, ``l_aux`` over all tokens). Two and four
spawned gloo ranks of the port, each fed its rows ``r::world``, must give
that step's losses and every parameter after three AdamW steps, for the
grids (data, expert) = (1, 2), (2, 1) and (2, 2), at ZeRO stages 0 and 3,
at gas 1 and 2, and with a loss mask whose token counts differ between
the ranks. A skewed gate makes the expert queues overflow at capacity
factor 1.0, so which tokens drop depends on the global order: gating each
rank's tokens alone gives another keep set (checked here on the batch).
The gradient is clipped at a norm the steps reach, so a norm that counted
an expert bank twice would change the update. Each rank holds its E / ep
experts; a tag saved at ep 2 has the JAX tag's keys and shapes, and tags
load across expert-parallel sizes (2 → 1 and 1 → 2) with the same params.

Tolerances: losses rtol 1e-4, params rtol 1e-4 / atol 1e-5 (fp32 on both
sides; the sums run in other orders), as ``test_torch_llama_train.py``.
The ranks import no JAX: this module imports it inside its functions.
"""

import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2_moe as tmoe
from deepspeed_tpu_torch.models.gpt2 import GPT2Config
from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (flatten_state, read_state,
                                                                   wait_for_pending_saves)
from tests.torch_world import World

TINY = dict(vocab_size=64, n_positions=32, n_embd=32, n_layer=4, n_head=4, remat=False)
E, SEQ, STEPS, ROWS = 4, 16, 3, 16
MOE = dict(num_experts=E, capacity_factor=1.0)
SKEW = 1.0                      # added to the gate's column 0: expert 0 overflows
CLIP = 0.3
# (name, (data, expert), ZeRO stage, gas, loss mask)
CASES = {2: [("d1e2_s0_gas1", (1, 2), 0, 1, False), ("d2e1_s3_gas1", (2, 1), 3, 1, False),
             ("d1e2_s3_gas2_mask", (1, 2), 3, 2, True),
             ("d2e1_s0_gas2_mask", (2, 1), 0, 2, True)],
         4: [("d2e2_s3_gas1", (2, 2), 3, 1, False), ("d2e2_s0_gas2_mask", (2, 2), 0, 2, True)]}
LOSS_TOL = dict(rtol=1e-4)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _tcfg(**over):
    return GPT2Config(**{**TINY, **over}, dtype=torch.float32)


def _jax_params(seed=0):
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.models.gpt2 import GPT2Config as JConfig
    from deepspeed_tpu.models.gpt2_moe import MoEGPT2

    model = MoEGPT2(JConfig(**TINY, dtype=jnp.float32), **MOE)
    params = jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(seed)))
    params["moe"]["gate"]["wg"] = params["moe"]["gate"]["wg"] + np.array(
        [SKEW] + [0.0] * (E - 1), np.float32)
    return params


def _batch(mask, seed=0):
    """Token rows; with ``mask``, ~90% of every fourth row's targets kept
    (rank 0's at two and four ranks) and ~15% of the others'."""
    rs = np.random.RandomState(seed)
    batch = {"input_ids": rs.randint(0, TINY["vocab_size"], size=(ROWS, SEQ)).astype(np.int32)}
    if mask:
        keep = np.where(np.arange(ROWS)[:, None] % 4 == 0, 0.9, 0.15)
        batch["loss_mask"] = (rs.rand(ROWS, SEQ) < keep).astype(np.float32)
    return batch


def _config(grid, stage, gas):
    data, expert = grid
    return {"train_batch_size": ROWS, "gradient_accumulation_steps": gas,
            "steps_per_print": 0, "gradient_clipping": CLIP,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 100},
            "tpu": {"data": data, "expert": expert}}


def _engine(np_params, grid, stage, gas):
    model = tmoe.params_from_jax(np_params, _tcfg(), ep_size=grid[1], **MOE)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=_config(grid, stage, gas),
                                                device="cpu")
    return engine


def _params_of(engine):
    return {k[len("params/"):]: v.numpy().copy() for k, v in flatten_state(engine).items()
            if k.startswith("params/")}


def _ranks(rank, world, out_dir, np_params):
    out = {}
    for name, grid, stage, gas, mask in CASES[world]:
        batch = _batch(mask)
        engine = _engine(np_params, grid, stage, gas)
        rows = {k: torch.from_numpy(v[rank::world]) for k, v in batch.items()}
        losses = [float(engine.train_batch(rows)) for _ in range(STEPS)]
        out[name] = {"losses": losses, "grad_norm": engine.get_global_grad_norm(),
                     "params": _params_of(engine),
                     "local_experts": next(p.shape[0] for p in engine._plan.params
                                           if p.name == "moe.0.experts.wi"),
                     "expert_units": len(engine._expert_units)}
        if world == 2 and stage == 3:
            # a tag of this grid, loaded by an engine of the other grid
            tag_dir = os.path.join(out_dir, f"tag_{name}")
            engine.save_checkpoint(tag_dir)
            wait_for_pending_saves()
            other = (2, 1) if grid == (1, 2) else (1, 2)
            loaded = _engine(_jax_params_like(np_params), other, 0, 1)
            loaded.load_checkpoint(tag_dir)
            out[name]["loaded_by_other_grid"] = _params_of(loaded)
            out[name]["tag"] = tag_dir
    return out


def _jax_params_like(np_params):
    """Other weights of the same tree (a load must replace every one)."""
    rs = np.random.RandomState(7)
    walk = lambda t: {k: walk(v) if isinstance(v, dict)
                      else rs.standard_normal(np.shape(v)).astype(np.float32)
                      for k, v in t.items()}
    return walk(np_params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' results, and the JAX engine's on the same global
    batches (one run per gas and mask), computed side by side."""
    import jax

    import deepspeed_tpu
    import jax.numpy as jnp

    from deepspeed_tpu.models.gpt2 import GPT2Config as JConfig
    from deepspeed_tpu.models.gpt2_moe import MoEGPT2
    from deepspeed_tpu.runtime.checkpoint_engine.engine import _flatten_state

    params = _jax_params()
    worlds = {w: World(_ranks, w, str(tmp_path_factory.mktemp(f"moe_world{w}")), args=(params,))
              for w in CASES}
    ref = {}
    for gas, mask in ((1, False), (2, True)):
        model = MoEGPT2(JConfig(**TINY, dtype=jnp.float32), **MOE)
        eng, *_ = deepspeed_tpu.initialize(model=model, model_parameters=params,
                                           config={**_config((1, 1), 1, gas), "tpu": {}})
        batch = _batch(mask)
        ref[gas, mask] = {"losses": [float(eng.train_batch(batch)) for _ in range(STEPS)],
                          "grad_norm": eng.get_global_grad_norm(),
                          "params": jax.tree.map(np.asarray, eng.state.params)}
        if gas == 1:                        # what the JAX engine's tag holds
            ref["flat"] = {k: np.asarray(v) for k, v in _flatten_state(eng.state).items()}
    return {"params": params, "jax": ref, "ranks": {w: world.join() for w, world in worlds.items()}}


def _jax_leaf(tree, name):
    parts = name.split(".")
    if parts[0] == "blocks":
        return tree["blocks"][parts[2]][int(parts[1])]
    leaf = tree
    for key in parts:
        leaf = leaf[key]
    return leaf


def _assert_like_jax(got, ref, what):
    np.testing.assert_allclose(got["losses"], ref["losses"], err_msg=what, **LOSS_TOL)
    assert got["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-4), what
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, _jax_leaf(ref["params"], name), err_msg=f"{what} {name}",
                                   **PARAM_TOL)


@pytest.mark.parametrize("world,case", [(w, c[0]) for w, cases in CASES.items() for c in cases])
def test_ranks_train_like_the_jax_one_program_engine(runs, world, case):
    _, grid, _, gas, mask = next(c for c in CASES[world] if c[0] == case)
    ref = runs["jax"][gas, mask]
    assert ref["grad_norm"] > CLIP
    for rank, got in enumerate(runs["ranks"][world]):
        _assert_like_jax(got[case], ref, f"rank {rank} of {world}, {case}")
        assert got[case]["local_experts"] == E // grid[1]
        assert got[case]["expert_units"] == (2 if grid[1] > 1 else 0)
    assert len({tuple(got[case]["losses"]) for got in runs["ranks"][world]}) == 1


def test_the_skewed_gate_overflows_and_global_gating_decides():
    """On the first MoE layer's input of the batch: expert 0's queue
    overflows at capacity factor 1.0, and gating each rank's rows alone
    keeps another set of tokens than gating them together."""
    from deepspeed_tpu_torch.moe.sharded_moe import _top1_route

    model = tmoe.params_from_jax(_jax_params(), _tcfg(), **MOE)
    ids = torch.from_numpy(_batch(False)["input_ids"]).long()
    with torch.no_grad():
        x = model._block(model._embed(ids), model.blocks[0])
        _, h = model._attn_half(x, model.blocks[1])
        logits = h.reshape(-1, h.shape[-1]) @ model.moe[0].gate.wg
    _, eidx, _, w, cap = _top1_route(logits)
    kept = (w[:, 0] > 0).reshape(ROWS, SEQ)
    assert (~kept).sum() > 0 and (eidx[:, 0] == 0).sum() > cap
    per_rank = torch.zeros_like(kept)
    for r in range(2):
        rows = logits.reshape(ROWS, SEQ, -1)[r::2].reshape(-1, logits.shape[-1])
        per_rank[r::2] = (_top1_route(rows)[3][:, 0] > 0).reshape(-1, SEQ)
    assert not torch.equal(per_rank, kept)


def test_masked_token_counts_differ_between_the_ranks():
    for world in CASES:
        mask = _batch(True)["loss_mask"][:, 1:]
        counts = [mask[r::world].sum() for r in range(world)]
        assert counts[0] > 2 * max(counts[1:])


def test_an_ep2_tag_has_the_jax_tags_keys_and_shapes(runs):
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import state_from_jax

    jax_state = state_from_jax(runs["jax"]["flat"])
    port_dir = runs["ranks"][2][0]["d1e2_s3_gas2_mask"]["tag"]
    with open(f"{port_dir}/latest") as f:
        port = read_state(f"{port_dir}/{f.read().strip()}", ("params", "master", "opt_state"),
                          "cpu")
    assert port["params/moe.experts.wi"].shape == (TINY["n_layer"] // 2, E, TINY["n_embd"],
                                                   4 * TINY["n_embd"])
    shapes = lambda s: {k: tuple(v.shape) for k, v in s.items()
                        if k.split("/")[0] in ("params", "master", "opt_state")}
    assert shapes(port) == shapes(jax_state)


@pytest.mark.parametrize("case", ["d1e2_s3_gas2_mask", "d2e1_s3_gas1"])
def test_tags_load_across_expert_parallel_sizes(runs, case):
    for rank, got in enumerate(runs["ranks"][2]):
        loaded = got[case]["loaded_by_other_grid"]
        assert loaded.keys() == got[case]["params"].keys()
        for name, p in got[case]["params"].items():
            np.testing.assert_array_equal(loaded[name], p, err_msg=f"rank {rank} {name}")


def test_an_ep2_tag_loads_in_one_process(runs):
    got = runs["ranks"][2][0]["d1e2_s3_gas2_mask"]
    engine = _engine(_jax_params_like(runs["params"]), (1, 1), 1, 1)
    engine.load_checkpoint(got["tag"])
    for name, p in _params_of(engine).items():
        np.testing.assert_array_equal(p, got["params"][name], err_msg=name)
