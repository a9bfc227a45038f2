"""The MoE GPT-2 under ``offload_optimizer``, in the port against the JAX
engine, on the CPU (helpers shared with ``test_torch_gpt2_moe.py``; the
other switches of one card: ``test_torch_gpt2_moe_zero_init.py`` and
``test_torch_gpt2_moe_sparse.py``).

Three engine steps (gas 2, a loss mask, AdamW with clipping) of the same
weights at stage 2 with the optimizer state in host memory match the JAX
engine's losses and gradient norm at 1e-4, whole-tree and streamed in small
chunks; the expert banks are units of the offloaded state.
"""

import numpy as np
import pytest

import deepspeed_tpu_torch
from tests.test_torch_gpt2_moe import (GAS, ROWS, STEPS, _batch, _jax_model, _jax_params, _port,
                                       _torch)


def _config(stage, **extra):
    return {"train_batch_size": ROWS * GAS, "gradient_accumulation_steps": GAS,
            "steps_per_print": 0, "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 100,
                                  **extra}}


def _jax_losses(params, config, batch):
    import deepspeed_tpu

    eng, *_ = deepspeed_tpu.initialize(model=_jax_model(), model_parameters=params,
                                       config=config)
    return [float(eng.train_batch(batch)) for _ in range(STEPS)], eng.get_global_grad_norm()


def _port_losses(engine, batch):
    losses = [float(engine.train_batch(_torch(batch))) for _ in range(STEPS)]
    return losses, engine.get_global_grad_norm()


def _tree_from_port(sd):
    """The JAX MoEGPT2 param tree of a port state dict (the inverse of
    ``params_from_jax``)."""
    tree, blocks, moe = {}, {}, {}
    for name, t in sd.items():
        parts, value = name.split("."), t.detach().numpy()
        if parts[0] == "blocks":
            blocks.setdefault(parts[2], {})[int(parts[1])] = value
        elif parts[0] == "moe":
            moe.setdefault(".".join(parts[2:]), {})[int(parts[1])] = value
        else:
            tree[name] = value
    tree["blocks"] = {k: np.stack([v[i] for i in sorted(v)]) for k, v in blocks.items()}
    tree["moe"] = {}
    for dotted, v in moe.items():
        node = tree["moe"]
        *path, leaf = dotted.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.stack([v[i] for i in sorted(v)])
    return tree


OFFLOAD = {"offload_optimizer": {"device": "cpu"}}


@pytest.fixture(scope="module")
def jax_offloaded():
    params = _jax_params(seed=12)
    batch = _batch(ROWS * GAS, seed=12, mask=True)
    return params, batch, _jax_losses(params, _config(2, **OFFLOAD), batch)


@pytest.mark.parametrize("streamed", [False, True], ids=["whole", "streamed"])
def test_offloaded_moe_trains_like_the_jax_engine(monkeypatch, jax_offloaded, streamed):
    params, batch, (ref_losses, ref_norm) = jax_offloaded
    if streamed:
        monkeypatch.setenv("DS_TPU_FORCE_STREAMED_OFFLOAD", "1")
        monkeypatch.setenv("DS_TPU_OFFLOAD_MASTER", "host")
        monkeypatch.setenv("DS_TPU_OFFLOAD_CHUNK_BYTES", "4096")
    engine, *_ = deepspeed_tpu_torch.initialize(model=_port(params), config=_config(2, **OFFLOAD),
                                                device="cpu")
    assert engine._offload is not None and engine._offload.streamed == streamed
    experts = [u for u, unit in enumerate(engine._plan.units)
               if any(engine._param_names[i].endswith("experts.wi") for i in unit.params)]
    assert experts          # the expert banks are units of the offloaded state
    losses, norm = _port_losses(engine, batch)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert norm == pytest.approx(ref_norm, rel=1e-4)
    assert engine.opt_state.mu[experts[0]].device.type == "cpu"
