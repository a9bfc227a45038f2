"""World-agnostic tags across world sizes and ZeRO stages, against the JAX tag.

Two spawned gloo ranks train a small GPT-2 (bf16 with fp32 masters) at
ZeRO stage 3 and save a tag; rank 0 alone, without a process group, loads
it into a stage-1 engine built from other weights, trains on and saves a
second tag; the two ranks form a new group and load that one at stage 3.
Each load restores the saved state (params, masters, moments, counters)
bit for bit, and both tags hold exactly the keys and shapes a one-process
stage-0 engine's state has: no partition and no padding reaches a file.
The world-2 save gathers one unit at a time: the gathered buffers alive at
once never exceed the largest unit's fp32 bytes, and rank 1, which does
not write, keeps nothing.
Then the ranks carry a JAX tag (``state_from_jax``, as
``test_torch_checkpoint.py`` carries one into a world of one) into a
stage-2 engine at world 2, whose next step's loss equals the JAX engine's
within 1e-4.

The ranks import no JAX: this module imports it inside its functions.
"""

import copy
import json
import os
import weakref

import numpy as np
import pytest
import torch

from tests.torch_world import World, init_rank, wait_for

SMALL = dict(vocab_size=128, n_positions=32, n_embd=64, n_layer=2, n_head=2, remat=False)
T, WORLD = 32, 2
CONFIG = {"train_batch_size": 8, "steps_per_print": 0, "gradient_clipping": 1.0,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
          "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 4,
                                                       "warmup_max_lr": 1e-3,
                                                       "warmup_type": "linear"}},
          "checkpoint": {"tag_validation": "Fail"}}
BF16 = {"bf16": {"enabled": True}}
JAX_STATE = "jax_state.pt"


def _config(stage, **extra):
    return copy.deepcopy({**CONFIG, "zero_optimization": {
        "stage": stage, "stage3_param_persistence_threshold": 1000}, **extra})


def _batch(seed):
    ids = np.random.RandomState(seed).randint(0, SMALL["vocab_size"], size=(8, T))
    return {"input_ids": ids.astype(np.int32)}


def _port_engine(np_params, config, dtype):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2

    model = gpt2.params_from_jax(np_params, gpt2.GPT2Config(**SMALL, dtype=dtype))
    return deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu")[0]


def _np_state(engine):
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import flatten_state

    return {k: v.detach().float().numpy().copy() if v.is_floating_point() else v.numpy().copy()
            for k, v in flatten_state(engine).items()}


def _gathered_bytes_alive(comm, fn):
    """Run ``fn()``; return the most bytes of ``all_gather_into_tensor``
    outputs the port held at once while it ran, and the number of gathers.
    Each gather runs into a staging tensor that is copied out, so the
    backend, which may release its tensors a little later on its own
    thread, holds none of the outputs."""
    real, alive, peak, calls = comm.all_gather_into_tensor, [0], [0], [0]

    def tracked(output_tensor, input_tensor, *args, **kwargs):
        staging = torch.empty_like(output_tensor)
        real(staging, input_tensor, *args, **kwargs)
        output_tensor.copy_(staging)
        n = output_tensor.numel() * output_tensor.element_size()
        alive[0] += n
        peak[0], calls[0] = max(peak[0], alive[0]), calls[0] + 1
        weakref.finalize(output_tensor, lambda: alive.__setitem__(0, alive[0] - n))
        return output_tensor

    comm.all_gather_into_tensor = tracked
    try:
        fn()
    finally:
        comm.all_gather_into_tensor = real
    return peak[0], calls[0]


# ------------------------------------------------------------ the ranks
def _ranks(rank, world, out_dir, weights):
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.runtime.checkpoint_engine import engine as ck

    out, tags = {}, os.path.join(out_dir, "tags")
    rows = lambda b: {k: v[rank::world] for k, v in b.items()}

    # world 2, stage 3: two steps, a tag
    a = _port_engine(weights[0], _config(3, **BF16), torch.bfloat16)
    for seed in (1, 2):
        a.train_batch(rows(_batch(seed)))
    out["save_gathered"] = _gathered_bytes_alive(
        comm, lambda: a.save_checkpoint(tags, tag="w2_stage3"))
    out["largest_unit_fp32_bytes"] = 4 * max(u.length for u in a._plan.units)
    out["units"] = (len(a._plan.units), sum(u.partitioned for u in a._plan.units))
    out["save_bytes"] = a._last_save["bytes"]
    out["kept_without_writing"] = len(ck.flatten_state(a, keep=False))
    out["saved_w2"] = _np_state(a)
    ck.wait_for_pending_saves()
    comm.barrier()
    comm.destroy_process_group()

    # rank 0 alone, no group, stage 1: load, a step, a tag
    done = os.path.join(out_dir, "w1_done")
    if rank == 0:
        b = _port_engine(weights[1], _config(1, **BF16), torch.bfloat16)
        path, _ = b.load_checkpoint(tags, tag="w2_stage3")
        out["loaded_w1"] = _np_state(b)
        out["w1_path"], out["w1_steps"] = os.path.basename(path), b.global_steps
        b.train_batch(_batch(3))
        b.save_checkpoint(tags, tag="w1_stage1")
        out["saved_w1"] = _np_state(b)
        ck.wait_for_pending_saves()
        open(done, "w").close()
    wait_for(done)

    # a new world of 2, stage 3: load the world-1 tag
    init_rank(rank, world, os.path.join(out_dir, "rendezvous2"))
    c = _port_engine(weights[2], _config(3, **BF16), torch.bfloat16)
    c.load_checkpoint(tags, tag="w1_stage1")
    out["loaded_w2"] = _np_state(c)

    # a JAX tag carried into a world of 2 at stage 2, one more step
    wait_for(os.path.join(out_dir, JAX_STATE))
    jax_tag = torch.load(os.path.join(out_dir, JAX_STATE), weights_only=False)
    d = _port_engine(weights[2], _config(2), torch.float32)
    assert set(jax_tag["state"]) == set(ck.flatten_state(d))
    ck.apply_flat_state(d, jax_tag["state"])
    ck.apply_restored_meta(d, jax_tag["meta"])
    out["jax_steps"] = d.global_steps
    out["jax_next_loss"] = float(d.train_batch(rows(_batch(3))))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and, meanwhile, the JAX engine's tag and its
    next step's loss."""
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    import deepspeed_tpu
    from deepspeed_tpu.models import gpt2 as jgpt2
    from deepspeed_tpu.runtime.checkpoint_engine import engine as jck

    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import state_from_jax

    out_dir = str(tmp_path_factory.mktemp("zero_ckpt"))
    model = jgpt2.GPT2Model(jgpt2.GPT2Config(**SMALL, dtype=jnp.float32))
    shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    weights = []
    for seed in range(3):
        rng = np.random.RandomState(seed)
        weights.append(jax.tree.map(
            lambda s: (0.02 * rng.randn(*s.shape)).astype(np.float32), shapes))
    world = World(_ranks, WORLD, out_dir, args=(weights,))

    cfg = _config(0)
    eng, *_ = deepspeed_tpu.initialize(model=model, model_parameters=weights[0], config=cfg)
    eng.train_batch(_batch(1))
    eng.train_batch(_batch(2))
    save_dir = os.path.join(out_dir, "jax_tags")
    eng.save_checkpoint(save_dir)
    jck.wait_for_pending_saves()
    jax_next_loss = float(eng.train_batch(_batch(3)))
    tag_dir = os.path.join(save_dir, "global_step2")
    with ocp.PyTreeCheckpointer() as ckptr:
        flat = jax.tree.map(np.asarray, ckptr.restore(os.path.join(tag_dir, "state")))
    with open(os.path.join(tag_dir, "client_state.json")) as f:
        meta = json.load(f)
    tmp = os.path.join(out_dir, JAX_STATE + ".tmp")
    torch.save({"state": state_from_jax(flat), "meta": meta}, tmp)
    os.replace(tmp, os.path.join(out_dir, JAX_STATE))
    return {"ranks": world.join(), "jax_next_loss": jax_next_loss, "jax_steps": 2,
            "tags": os.path.join(out_dir, "tags"), "weights": weights}


def _assert_bitwise(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), f"{what}: {k}"


def test_the_save_gathers_one_unit_at_a_time_and_only_rank0_keeps(runs):
    """At world 2 / stage 3 the save gathers the masters and both Adam
    moments of every unit and the params of every partitioned one, unit by
    unit: the gathered buffers alive at once stay within the largest unit's
    fp32 bytes on both ranks; rank 1 writes and keeps nothing."""
    for rank, got in enumerate(runs["ranks"]):
        peak, calls = got["save_gathered"]
        units, partitioned = got["units"]
        assert calls == 3 * units + partitioned, rank
        assert 0 < peak <= got["largest_unit_fp32_bytes"], (rank, peak)
        assert got["kept_without_writing"] == 0
    assert runs["ranks"][0]["save_bytes"] > 0 and runs["ranks"][1]["save_bytes"] == 0


def test_ranks_hold_the_same_whole_state(runs):
    r0, r1 = runs["ranks"]
    for key in ("saved_w2", "loaded_w2"):
        _assert_bitwise(r1[key], r0[key], key)


def test_world2_stage3_tag_restores_bitwise_at_world1_stage1(runs):
    r0 = runs["ranks"][0]
    assert (r0["w1_path"], r0["w1_steps"]) == ("w2_stage3", 2)
    _assert_bitwise(r0["loaded_w1"], r0["saved_w2"], "world 1 after the load")


def test_world1_stage1_tag_restores_bitwise_at_world2_stage3(runs):
    for rank, got in enumerate(runs["ranks"]):
        _assert_bitwise(got["loaded_w2"], runs["ranks"][0]["saved_w1"], f"rank {rank}")


def test_tags_hold_whole_tensors_without_padding(runs):
    """Both tags, written at world 2 / stage 3 and world 1 / stage 1, hold
    the keys, shapes and dtypes of a one-process stage-0 engine's state;
    the world they came from is in client_state.json only."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine import engine as ck

    ref = ck.flatten_state(_port_engine(runs["weights"][0], _config(0, **BF16),
                                        torch.bfloat16))
    for tag, dp in (("w2_stage3", 2), ("w1_stage1", 1)):
        tag_dir = os.path.join(runs["tags"], tag)
        state = ck.read_state(tag_dir, ck.STATE_FIELDS, "cpu")
        assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == \
            {k: (tuple(v.shape), v.dtype) for k, v in ref.items()}, tag
        with open(os.path.join(tag_dir, "client_state.json")) as f:
            meta = json.load(f)
        assert (meta["dp_world_size"], meta["world"]["dp_world_size"]) == (dp, dp)
    with open(os.path.join(runs["tags"], "latest")) as f:
        assert f.read() == "w1_stage1"


def test_a_jax_tag_continues_at_world2(runs):
    for got in runs["ranks"]:
        assert got["jax_steps"] == runs["jax_steps"]
        assert got["jax_next_loss"] == pytest.approx(runs["jax_next_loss"], rel=1e-4)


def test_tag_validation_parses_like_jax():
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig

    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig

    for value in ("Ignore", "Warn", "Fail", "fail"):
        cfg = {"train_batch_size": 8, "checkpoint": {"tag_validation": value,
                                                     "use_node_local_storage": True}}
        j, t = JConfig(copy.deepcopy(cfg)), TConfig(copy.deepcopy(cfg))
        for attr in ("checkpoint_tag_validation_enabled", "checkpoint_tag_validation_fail"):
            assert getattr(t, attr) == getattr(j, attr), (value, attr)
        assert t.checkpoint_config.use_node_local_storage is \
            j.checkpoint_config.use_node_local_storage is True
