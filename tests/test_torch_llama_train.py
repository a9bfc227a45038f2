"""The port's llama training engine against the JAX package, on the CPU (the
model's loss and gradients, and ``zero.Init`` with both offloads:
``test_torch_llama_grads.py``, which shares these helpers).

The JAX package's ``init_params`` draws the weights; ``params_from_jax``
copies them exactly into the port's ``LlamaModel``, and the same numpy
token batch goes into both. ``initialize`` trains every llama parameter;
one JAX engine run (3 steps, gas 2, a ``loss_mask`` whose token counts
differ between the two ranks' rows) is what the port is held to at 1e-4:
one process at stage 0, and two spawned gloo ranks at ZeRO stages 0-3 and
at stage 3 under ``remat``. The ranks' stage-3 gradients of one
microbatch equal stage 0's. A JAX tag saved after those steps continues in
the port (``state_from_jax``) with the JAX engine's losses, and a tag the
port trains is served by ``init_inference`` bit for bit.

The ranks import no JAX: this module imports it inside its functions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (apply_flat_state,
                                                                   flatten_state, state_from_jax,
                                                                   wait_for_pending_saves)
from tests.torch_world import World

TINY = dict(vocab_size=256, n_positions=32, n_embd=64, n_layer=2, n_head=4, n_kv_head=2,
            intermediate_size=128, remat=False)
LLAMA3 = {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 16}
T, WORLD, STEPS, GAS = 32, 2, 3, 2
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
THRESHOLD = 1000          # stage 3: the weights partitioned, the norm gains whole
CASES = {"untied_rep2": dict(mask=False),
         "tied_rep4_llama3_mask": dict(n_kv_head=1, tie_embeddings=True, rope_scaling=LLAMA3,
                                       mask=True),
         "tied_rep2_mask": dict(tie_embeddings=True, mask=True)}
STAGES = (0, 1, 2, 3, "remat")


def _tcfg(**over):
    return tllama.LlamaConfig(**{**TINY, **over}, dtype=torch.float32)


def _jcfg(**over):
    import jax.numpy as jnp

    from deepspeed_tpu.models import llama as jllama

    return jllama.LlamaConfig(**{**TINY, **over}, dtype=jnp.float32)


def _jax_params(cfg, seed=0):
    import jax

    from deepspeed_tpu.models import llama as jllama

    return jax.tree.map(np.asarray, jllama.LlamaModel(cfg).init_params(jax.random.PRNGKey(seed)))


def _batch(rows, seed=0, mask=False):
    """Token rows; with ``mask``, ~90% of the even rows' targets kept (rank
    0's) and ~30% of the odd rows' (rank 1's)."""
    rs = np.random.RandomState(seed)
    batch = {"input_ids": rs.randint(0, TINY["vocab_size"], size=(rows, T)).astype(np.int32)}
    if mask:
        keep = np.where(np.arange(rows)[:, None] % 2 == 0, 0.9, 0.3)
        batch["loss_mask"] = (rs.rand(rows, T) < keep).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_key(name):
    return ("blocks", name.split(".")[2], int(name.split(".")[1])) if name.startswith("blocks.") \
        else (name,)


def _jax_leaf(tree, name):
    key = _jax_key(name)
    return tree["blocks"][key[1]][key[2]] if len(key) == 3 else tree[name]


def _config(stage, **extra):
    return {"train_batch_size": 8 * GAS, "gradient_accumulation_steps": GAS,
            "steps_per_print": 0, "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage,
                                  "stage3_param_persistence_threshold": THRESHOLD, **extra}}


def _port_engine(np_params, config, **over):
    model = tllama.params_from_jax(np_params, _tcfg(**over))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu")
    return engine


def _rows(batch, rank):
    return {k: v[rank::WORLD] for k, v in batch.items()}


def _params_of(engine):
    return {k[len("params/"):]: v.numpy().copy() for k, v in flatten_state(engine).items()
            if k.startswith("params/")}


def _ranks(rank, world, out_dir, np_params):
    batch, out = _batch(8 * GAS, mask=True), {}
    for stage in STAGES:
        remat = stage == "remat"
        engine = _port_engine(np_params, _config(3 if remat else stage),
                              remat="full" if remat else False)
        losses = [float(engine.train_batch(_rows(batch, rank))) for _ in range(STEPS)]
        out[stage] = {"losses": losses, "grad_norm": engine.get_global_grad_norm(),
                      "params": _params_of(engine)}
    grads = {}
    for stage in (0, 3):
        engine = _port_engine(np_params, _config(stage))
        engine.backward(engine.forward(_rows(batch, rank)))
        z = engine._zero
        grads[stage] = dict(zip(engine._param_names, z.to_host(z.reduced_grads(1))))
    out["grads"] = grads
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, the JAX engine's (3 steps, a tag saved after
    them, 2 steps more) and the weights, computed side by side."""
    import jax

    import deepspeed_tpu
    from deepspeed_tpu.models import llama as jllama

    params = _jax_params(_jcfg(), seed=6)
    world = World(_ranks, WORLD, str(tmp_path_factory.mktemp("llama_zero")), args=(params,))
    tag_dir = str(tmp_path_factory.mktemp("llama_jax_tag"))
    eng, *_ = deepspeed_tpu.initialize(model=jllama.LlamaModel(_jcfg()), model_parameters=params,
                                       config=_config(1))
    batch = _batch(8 * GAS, mask=True)
    ref = {"losses": [float(eng.train_batch(batch)) for _ in range(STEPS)],
           "grad_norm": eng.get_global_grad_norm(),
           "params": jax.tree.map(np.asarray, eng.state.params)}
    eng.save_checkpoint(tag_dir)
    ref["continued"] = [float(eng.train_batch(batch)) for _ in range(2)]
    return {"params": params, "jax": ref, "tag_dir": tag_dir, "ranks": world.join()}


def _assert_like_jax(got, ref, what):
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4, err_msg=what)
    assert got["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-4), what
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, _jax_leaf(ref["params"], name), rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what} {name}")


def test_initialize_trains_every_parameter_like_the_jax_engine(runs):
    engine = _port_engine(runs["params"], _config(0))
    names = [n for n, _ in engine.module.named_parameters()]
    assert engine._param_names == names and len(names) == 3 + 9 * TINY["n_layer"]
    batch = _batch(8 * GAS, mask=True)
    got = {"losses": [float(engine.train_batch(batch)) for _ in range(STEPS)],
           "grad_norm": engine.get_global_grad_norm(), "params": _params_of(engine)}
    _assert_like_jax(got, runs["jax"], "one process")
    assert got["losses"][-1] < got["losses"][0]
    before = tllama.params_from_jax(runs["params"], _tcfg()).state_dict()
    assert all(not torch.equal(torch.from_numpy(got["params"][n]), before[n]) for n in names)


@pytest.mark.parametrize("stage", STAGES)
def test_two_ranks_train_like_the_jax_engine(runs, stage):
    for rank, got in enumerate(runs["ranks"]):
        _assert_like_jax(got[stage], runs["jax"], f"rank {rank} stage {stage}")
    a, b = (got[stage] for got in runs["ranks"])
    assert a["losses"] == b["losses"]


def test_masked_token_counts_differ_between_the_ranks():
    mask = _batch(8 * GAS, mask=True)["loss_mask"][:, 1:]
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


# ------------------------------------------------------------- checkpoints
def test_jax_tag_continues_in_the_port(runs):
    import jax
    import orbax.checkpoint as ocp

    with open(f"{runs['tag_dir']}/latest") as f:
        tag = f.read().strip()
    with ocp.PyTreeCheckpointer() as ckptr:
        flat = jax.tree.map(np.asarray, ckptr.restore(f"{runs['tag_dir']}/{tag}/state"))
    other = _jax_params(_jcfg(), seed=9)
    engine = _port_engine(other, _config(1))
    state = state_from_jax(flat)
    assert set(state) == set(flatten_state(engine))
    assert {k for k in state if k.startswith("params/blocks.1.")} == \
        {f"params/blocks.1.{key}" for key in tllama.BLOCK_KEYS}
    apply_flat_state(engine, state)
    assert engine.global_steps == STEPS
    batch = _batch(8 * GAS, mask=True)
    losses = [float(engine.train_batch(batch)) for _ in range(2)]
    np.testing.assert_allclose(losses, runs["jax"]["continued"], rtol=1e-4)


def test_a_trained_tag_is_served_bit_for_bit(tmp_path):
    cfg = _tcfg(tie_embeddings=True)
    model = tllama.LlamaModel(cfg).init_params(torch.Generator().manual_seed(10))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=_config(1), device="cpu")
    for _ in range(2):
        engine.train_batch(_batch(8 * GAS, seed=11))
    engine.save_checkpoint(str(tmp_path))
    wait_for_pending_saves()
    trained = engine.module_state_dict()
    served = deepspeed_tpu_torch.init_inference(
        tllama.LlamaModel(dataclasses.replace(cfg, remat=True)),
        config={"checkpoint": str(tmp_path), "dtype": "float32", "max_out_tokens": 32},
        device="cpu")
    got = served.module.state_dict()
    assert got.keys() == trained.keys()
    assert all(torch.equal(got[n], trained[n]) for n in got)
    ids = torch.from_numpy(_batch(2, seed=12)["input_ids"][:, :8]).long()
    with torch.no_grad():
        np.testing.assert_array_equal(served(ids).numpy(), engine.module.apply(ids).numpy())
    out = served.generate(ids, max_new_tokens=4)
    assert out.shape == (2, 12) and torch.equal(out[:, :8], ids)


def test_later_knobs_raise():
    """Sequence parallelism is still a later slice of the port; the "dots"
    and "attn" remat policies are carried and "attn_mlp" is refused, as in
    JAX."""
    with pytest.raises(NotImplementedError):
        _tcfg(sequence_parallel="ring")
    assert _tcfg(remat="dots").remat == "dots" and _tcfg(remat="attn").remat == "attn"
    with pytest.raises(ValueError):
        _tcfg(remat="attn_mlp")


def test_num_params_and_flops_match_jax():
    from deepspeed_tpu.models import llama as jllama

    for name in ("llama-tiny", "llama3.2-1b"):
        c, j = tllama.PRESETS[name], jllama.PRESETS[name]
        assert c.num_params() == j.num_params()
        assert c.flops_per_token(2048) == j.flops_per_token(2048)
    c = _tcfg(tie_embeddings=True)
    assert c.num_params() == sum(p.numel() for p in tllama.LlamaModel(c).parameters())
