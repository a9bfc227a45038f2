"""Compression training under ZeRO stage 3 and ``offload_param`` against the
JAX package.

Six fp32 steps of a 2-layer GPT-2 under ``compression_training`` (MoQ 8 -> 6
bits on the blocks from step 2, a bit every 2 steps; l1 sparse pruning of
the fc leaves from step 3), then ``redundancy_clean``, at three placements
of the port's engine: stage 1 (whole units), stage 3 with the weights
fetched and the biases and gains in the persistent unit, and stage 3 with
``offload_param: cpu`` and every unit fetched from host memory. Each
placement runs on one rank here and on two spawned gloo ranks (rows
``rank::2`` of the global batch), and the JAX engine runs the same weights
at stage 3 and at stage 3 with ``offload_param`` on the conftest's 8-device
CPU mesh (``offload_param`` in ``test_torch_compression_offload.py``, one
JAX engine a file). Held: every run's losses (rtol 1e-5, the tolerance of the
compression engine tests) and final params (rtol 1e-4, atol 1e-5, the
ZeRO tests' tolerance for params after AdamW steps, whose normalized update
turns a rounding-sized gradient difference into a visible one on a weight
with a near-zero gradient) against the JAX run at its stage and placement; every stage-3 run
against the port's stage-1 run of the same world bit for bit (losses, params, cleaned
params: the compressed values are computed from the same stacked values,
and the same gradients reach the same per-unit updates).
``test_torch_compression_placements.py`` holds the port's placements to
one another where no JAX run is needed.

The ranks import no JAX: this module imports it inside its functions.
"""

import numpy as np
import pytest
import torch

from tests.torch_world import World

SMALL = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2, n_head=2, remat=False,
             use_flash_attention=False)
STEPS, T, ROWS = 6, 32, 8
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
BLOCK = {
    "weight_quantization": {
        "shared_parameters": {"enabled": True, "schedule_offset": 2, "quantization_period": 2},
        "different_groups": {"g": {"params": {"start_bits": 8, "target_bits": 6},
                                   "modules": ["blocks"]}}},
    "sparse_pruning": {
        "shared_parameters": {"enabled": True, "schedule_offset": 3},
        "different_groups": {"g": {"params": {"dense_ratio": 0.5}, "modules": ["blocks/fc"]}}}}
CONFIG = {"train_batch_size": ROWS, "steps_per_print": 0,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
          "compression_training": BLOCK}
# the port's placements (the ZeRO block, and the JAX placement a run is
# held to)
PLACEMENTS = {
    "stage1": ({"stage": 1}, "stage3"),
    "stage3": ({"stage": 3, "stage3_param_persistence_threshold": 100}, "stage3"),
    "stage3_offload": ({"stage": 3, "stage3_param_persistence_threshold": 0,
                        "offload_param": {"device": "cpu"}}, "stage3_offload"),
}
JAX_PLACEMENTS = {"stage3": {"stage": 3},
                  "stage3_offload": {"stage": 3, "offload_param": {"device": "cpu"}}}


def _batch():
    return {"input_ids": np.random.RandomState(3).randint(
        0, SMALL["vocab_size"], size=(ROWS, T)).astype(np.int32)}


def _run(state, zero, rank=0, world=1, steps=STEPS, extra=None):
    """The port's engine from ``state`` at ``zero``: its losses, final params
    and cleaned params (each whole, on the host)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.compression import compress as tcomp
    from deepspeed_tpu_torch.models import gpt2 as tgpt2

    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config={**CONFIG, "zero_optimization": zero, **(extra or {})},
        device="cpu", model_parameters={k: v.clone() for k, v in state.items()})
    batch = {k: v[rank::world] for k, v in _batch().items()}
    losses = [float(engine.train_batch(batch)) for _ in range(steps)]
    snap = lambda: {k: v.clone() for k, v in engine.module_state_dict().items()}
    params = snap()
    tcomp.redundancy_clean(engine, {"compression_training": BLOCK})
    return {"losses": losses, "params": params, "cleaned": snap(),
            "fetched": (sum(engine._zero.fetched), len(engine._zero.fetched)),
            "served_devices": {t.device.type for t in engine._zero.served.values()},
            "eigen": engine.block_eigenvalue}


def _ranks(rank, world, out_dir, state, names):
    return {name: _run(state, PLACEMENTS[name][0], rank, world) for name in names}


def placement_runs(tmp, names, jax_name):
    """The port's placements ``names`` on two spawned ranks (started first)
    and on one rank here, and the JAX engine at ``jax_name``, each from the
    same weights."""
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu
    from deepspeed_tpu.models import gpt2 as jgpt2
    from deepspeed_tpu_torch.models import gpt2 as tgpt2

    shapes = jax.eval_shape(lambda: jgpt2.GPT2Model(jgpt2.GPT2Config(
        **SMALL, dtype=jnp.float32)).init_params(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(0)
    np_params = jax.tree.map(lambda s: (0.02 * rs.randn(*s.shape)).astype(np.float32), shapes)
    state = tgpt2.params_from_jax(np_params, tgpt2.GPT2Config(
        **SMALL, dtype=torch.float32)).state_dict()
    world = World(_ranks, 2, tmp, args=(state, names))
    one = {name: _run(state, PLACEMENTS[name][0]) for name in names}
    engine, *_ = deepspeed_tpu.initialize(
        model=jgpt2.GPT2Model(jgpt2.GPT2Config(**SMALL, dtype=jnp.float32)),
        model_parameters=jax.tree.map(jnp.asarray, np_params),
        config={**CONFIG, "zero_optimization": JAX_PLACEMENTS[jax_name]})
    losses = [float(engine.train_batch(_batch())) for _ in range(STEPS)]
    jax_run = {"losses": losses, "params": jax.tree.map(np.asarray, engine.state.params)}
    return {"one": one, "two": world.join(), "jax": jax_run}


def _jax_leaf(jtree, name):
    from deepspeed_tpu_torch.compression.compress import param_path

    path, layer = param_path(name)
    node = jtree
    for part in path.split("/"):
        node = node[part]
    return np.asarray(node if layer is None else node[layer])


def held_to_jax(runs, placement, world):
    got = runs["one"][placement] if world == "one" else runs["two"][0][placement]
    want = runs["jax"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    for name, t in got["params"].items():
        np.testing.assert_allclose(t.numpy(), _jax_leaf(want["params"], name),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=name)
    if world == "two":
        # every rank holds the same params and losses
        other = runs["two"][1][placement]
        assert other["losses"] == got["losses"]
        for name, t in got["params"].items():
            assert torch.equal(other["params"][name], t), name


def held_to_stage_1(runs, placement, world):
    """The same stacked values give the same compressed values, whose
    gradients reach the same per-unit AdamW updates: losses, params and
    ``redundancy_clean``'s params equal stage 1's exactly."""
    for by in [runs["one"]] if world == "one" else runs["two"]:
        got, want = by[placement], by["stage1"]
        assert got["losses"] == want["losses"]
        for key in ("params", "cleaned"):
            assert got[key].keys() == want[key].keys()
            for name, t in got[key].items():
                assert torch.equal(t, want[key][name]), (key, name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return placement_runs(str(tmp_path_factory.mktemp("compression_zero3")),
                          ("stage1", "stage3"), "stage3")


@pytest.mark.parametrize("world", ["one", "two"])
@pytest.mark.parametrize("placement", ["stage1", "stage3"])
def test_losses_and_params_match_the_jax_engine(runs, placement, world):
    held_to_jax(runs, placement, world)


def test_stage_3_fetches_the_weights(runs):
    """Stage 3 fetches the weights' units, the persistent unit (biases and
    gains) stays whole; stage 1 fetches none."""
    assert runs["one"]["stage1"]["fetched"][0] == 0
    fetched, units = runs["one"]["stage3"]["fetched"]
    assert 0 < fetched == units - 1


@pytest.mark.parametrize("world", ["one", "two"])
def test_stage_3_equals_stage_1_bit_for_bit(runs, world):
    held_to_stage_1(runs, "stage3", world)
