"""The port's ZeRO-Infinity engine (params and Adam state on NVMe, layerwise
steps) against the JAX engine in memory, on the CPU.

The counterpart of the JAX ``test_layerwise_nvme_matches_inhbm``, which the
JAX run keeps among its slow tests; this one is not slow. A 4-layer fp32
GPT-2 at gpt2-tiny widths, its weights copied from the JAX package, trains
3 steps through ``initialize`` with ``offload_param: nvme`` (gas 1 and 2,
clipping on): losses and params within 1e-5 of the JAX engine (the
Infinity step clips by the JAX NVMe rule, which equals the in-memory one
whenever the norm is above the limit, as it is here). The gathered tree runs
the plain model; a save, a step, a load and the same step again give the
same loss and the same top-level weights; the NVMe files hold 12 bytes per
parameter. Its tags and ``DeepSpeedEngine``'s load into each other bit for
bit, in fp32 and in bf16 with fp32 masters.
"""

import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (flatten_state,
                                                                   wait_for_pending_saves)
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.runtime.zero.infinity import ZeroInfinityEngine

SMALL = dict(vocab_size=256, n_positions=32, n_embd=32, n_layer=4, n_head=4, remat=False)
STEPS = 3


def _config(gas, **zero):
    return {"train_batch_size": 8 * gas, "gradient_accumulation_steps": gas,
            "steps_per_print": 0, "gradient_clipping": 0.5,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-4,
                                                         "warmup_max_lr": 1e-3,
                                                         "warmup_num_steps": 2}},
            "zero_optimization": {"stage": 3, **zero}}


def _batch(seed=2, gas=1):
    return {"input_ids": np.random.RandomState(seed).randint(
        0, SMALL["vocab_size"], size=(8 * gas, 16)).astype(np.int32)}


@pytest.fixture(scope="module")
def jax_runs():
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu
    from deepspeed_tpu.models import gpt2 as jgpt2

    jcfg = jgpt2.GPT2Config(**SMALL, dtype=jnp.float32, use_flash_attention=False)
    params = jgpt2.GPT2Model(jcfg).init_params(jax.random.PRNGKey(1))
    out = {"params": jax.tree.map(np.asarray, params)}
    for gas in (1, 2):
        eng, *_ = deepspeed_tpu.initialize(model=jgpt2.GPT2Model(jcfg), model_parameters=params,
                                           config=_config(gas))
        out[gas] = {"losses": [float(eng.train_batch(_batch(gas=gas))) for _ in range(STEPS)],
                    "norm": eng.get_global_grad_norm(),
                    "params": jax.tree.map(np.asarray, eng.state.params)}
    return out


def _infinity(np_params, path, gas=1, dtype=torch.float32):
    model = tgpt2.params_from_jax(np_params, tgpt2.GPT2Config(**SMALL, dtype=dtype))
    config = _config(gas, offload_param={"device": "nvme", "nvme_path": str(path),
                                         "buffer_count": 3})
    if dtype == torch.bfloat16:
        config["bf16"] = {"enabled": True}
    engine, opt, loader, sched = deepspeed_tpu_torch.initialize(model=model, config=config,
                                                                device="cpu")
    assert isinstance(engine, ZeroInfinityEngine) and opt is engine.optimizer and loader is None
    return engine


def _in_memory(np_params, dtype):
    model = tgpt2.params_from_jax(np_params, tgpt2.GPT2Config(**SMALL, dtype=dtype))
    config = {**_config(1), "zero_optimization": {"stage": 1}}
    if dtype == torch.bfloat16:
        config["bf16"] = {"enabled": True}
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu")
    assert isinstance(engine, DeepSpeedEngine)
    return engine


@pytest.mark.parametrize("gas", [1, 2])
def test_layerwise_nvme_matches_jax_in_memory(jax_runs, tmp_path, gas):
    engine = _infinity(jax_runs["params"], tmp_path, gas)
    losses = [float(engine.train_batch(_batch(gas=gas))) for _ in range(STEPS)]
    ref = jax_runs[gas]
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    assert engine.last_grad_norm > 0.5 and ref["norm"] > 0.5      # the clip is active
    got = engine.gather_params()
    for name in ("wte", "wpe", "lnf_g", "lnf_b"):
        np.testing.assert_allclose(got[name].numpy(), ref["params"][name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    for key, stacked in got["blocks"].items():
        np.testing.assert_allclose(stacked.numpy(), ref["params"]["blocks"][key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    n = sum(v.size for v in jax_runs["params"]["blocks"].values()) + sum(
        v.size for k, v in jax_runs["params"].items() if k != "blocks")
    assert engine.optimizer.state_bytes() >= 12 * n


def test_gather_checkpoint_and_resume(jax_runs, tmp_path):
    engine = _infinity(jax_runs["params"], tmp_path / "swap")
    for _ in range(2):
        engine.train_batch(_batch())
    # the gathered tree runs the plain model
    tree = {k: v.numpy() for k, v in engine.gather_params().items() if k != "blocks"}
    tree["blocks"] = {k: v.numpy() for k, v in engine.gather_params()["blocks"].items()}
    plain = tgpt2.params_from_jax(tree, tgpt2.GPT2Config(**SMALL, dtype=torch.float32))
    assert torch.isfinite(plain.apply(torch.from_numpy(_batch()["input_ids"][:, :8]))).all()
    # save, drift, restore, and the same step again
    engine.save_checkpoint(str(tmp_path / "ck"), tag="t")
    shared = {n: v.clone() for n, v in engine.shared.items()}
    drift = float(engine.train_batch(_batch(5)))
    engine.load_checkpoint(str(tmp_path / "ck"))
    assert engine.global_steps == 2 and engine.optimizer.step_count == 2
    for n, v in engine.shared.items():
        assert torch.equal(v, shared[n]), n
    assert float(engine.train_batch(_batch(5))) == drift
    assert sorted(os.listdir(tmp_path / "ck")) == ["latest", "t"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_tags_load_between_infinity_and_the_engine(jax_runs, tmp_path, dtype):
    """A tag saved by ZeRO-Infinity restores bit for bit into the engine
    without offload, and one saved by that engine into ZeRO-Infinity; each
    then takes the saver's next step (within 1e-5 in fp32; in bf16 the two
    engines' steps round differently, as the card's NVMe phase holds them
    to 1%)."""
    rtol = 1e-5 if dtype == torch.float32 else 1e-2
    build = {"infinity": lambda i: _infinity(jax_runs["params"], tmp_path / f"swap{i}",
                                             dtype=dtype),
             "in_memory": lambda i: _in_memory(jax_runs["params"], dtype)}
    batch = _batch()
    for i, (saver, loader) in enumerate((("infinity", "in_memory"), ("in_memory", "infinity"))):
        src = build[saver](i)
        for _ in range(2):
            src.train_batch(batch)
        ckpt = str(tmp_path / f"ck{i}")
        src.save_checkpoint(ckpt)
        wait_for_pending_saves()
        saved = flatten_state(src)
        assert any(k.startswith("master/") for k in saved) == (dtype == torch.bfloat16)
        after = float(src.train_batch(batch))
        dst = build[loader](i)
        path, _ = dst.load_checkpoint(ckpt)
        assert path is not None and dst.global_steps == 2
        restored = flatten_state(dst)
        assert restored.keys() == saved.keys()
        for k, v in saved.items():
            assert torch.equal(restored[k], v), (loader, k)
        np.testing.assert_allclose(float(dst.train_batch(batch)), after, rtol=rtol)
