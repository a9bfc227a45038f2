"""The port's compression training engine against the JAX engine.

Six fp32 steps of a 2-layer GPT-2 engine under ``compression_training``
(MoQ 8 -> 6 bits on the blocks from step 2, a bit every 2 steps; l1 sparse
pruning of the fc leaves from step 3) across two stage boundaries and the
start of pruning against the JAX engine from the same weights (losses rtol
1e-5), then ``redundancy_clean`` and one more step on both; stage 3 with
a partitioned unit arms compression, and ``offload_param: nvme`` refuses it.
One JAX engine trains in this file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.compression.config import CompressionConfig as JCompressionConfig
from deepspeed_tpu.compression import compress as jcomp
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.compression import compress as tcomp
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from tests.test_torch_compression import SMALL, _block, _gpt2_pair, _jax_leaf


# ------------------------------------------------------------------ engine
ENGINE_BLOCK = {**_block("weight_quantization", ["blocks"]),
                **_block("sparse_pruning", ["blocks/fc"])}
ENGINE_CFG = {"train_batch_size": 8, "steps_per_print": 0,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
              "compression_training": ENGINE_BLOCK}


@pytest.fixture(scope="module")
def engine_runs():
    """Six steps of both engines from the same weights (stages open at steps
    2 and 4, pruning at 3), then redundancy_clean and a seventh step."""
    params, tmodel = _gpt2_pair()
    jeng, *_ = deepspeed_tpu.initialize(model=jgpt2.GPT2Model(jgpt2.GPT2Config(
        **SMALL, dtype=jnp.float32)), model_parameters=params, config=dict(ENGINE_CFG))
    teng, *_ = deepspeed_tpu_torch.initialize(model=tmodel, config=dict(ENGINE_CFG),
                                              device="cpu")
    batch = {"input_ids": np.random.RandomState(3).randint(
        0, SMALL["vocab_size"], size=(8, 32)).astype(np.int32)}
    jl = [float(jeng.train_batch(batch)) for _ in range(6)]
    tl = [float(teng.train_batch(batch)) for _ in range(6)]
    before = {n: p.detach().clone() for n, p in teng.module.named_parameters()}
    # the JAX redundancy_clean's body (compress.py:313-320), its finalize
    # jitted: run op by op it takes seconds here
    jeng.state = jeng.state._replace(params=jax.jit(jeng._compression.finalize)(
        jeng.state.params))
    tcomp.redundancy_clean(teng, {"compression_training": ENGINE_BLOCK})
    snap = lambda: ({n: p.detach().clone() for n, p in teng.module.named_parameters()},
                    jax.tree.map(np.asarray, jeng.state.params))
    cleaned = snap()
    jl.append(float(jeng.train_batch(batch)))
    tl.append(float(teng.train_batch(batch)))
    return {"jl": jl, "tl": tl, "before": before, "cleaned": cleaned, "after": snap(),
            "teng": teng}


def test_engine_losses_across_stage_boundaries_match_jax(engine_runs):
    np.testing.assert_allclose(engine_runs["tl"][:6], engine_runs["jl"][:6], rtol=1e-5)
    teng = engine_runs["teng"]
    assert teng._compressed.refreshes == 7 and teng._compression_at == 6


def _levels_and_zeros(stacked):
    """(distinct 6-bit levels, share of zeros, share of the entries at the
    smallest kept magnitude: the ties the l1 threshold keeps) of a stacked
    leaf."""
    scale = np.abs(stacked).max() / 31
    mag = np.abs(stacked)
    ties = float((mag == mag[mag > 0].min()).mean())
    return len(np.unique(np.round(stacked / scale))), float((stacked == 0).mean()), ties


@pytest.mark.parametrize("phase", ["cleaned", "after"])
def test_redundancy_clean_and_the_next_step_match_jax(engine_runs, phase):
    """The cleaned weights are the JAX ``finalize`` of the same weights (6
    bits on every block tensor, the fc leaves pruned to half), and both
    engines' cleaned weights hold at most 2^6 levels and half zeros. In fp32
    the JAX params are the masters, so the next step starts from the
    cleaned values on both engines: every weight moves by at most a few
    learning rates (an AdamW step), the pruned zeros stay near zero, and the
    losses agree."""
    tparams, jparams = engine_runs[phase]
    tclean, jclean = engine_runs["cleaned"]
    if phase == "cleaned":
        jtr = jcomp.CompressionTransform(
            JCompressionConfig.from_ds_config({"compression_training": ENGINE_BLOCK}),
            jax.eval_shape(lambda: jparams))
        before = {"blocks": {}}
        for name, t in engine_runs["before"].items():
            path, layer = tcomp.param_path(name)
            if layer is None:
                before[path] = t.numpy()
            else:
                before["blocks"].setdefault(path.split("/")[1], []).append(t.numpy())
        before["blocks"] = {k: np.stack(v) for k, v in before["blocks"].items()}
        want = jax.tree.map(np.asarray, jax.jit(jtr.finalize)(before))
        for name, t in tparams.items():
            ref = _jax_leaf(want, name)
            np.testing.assert_allclose(t.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max(),
                                       err_msg=name)
            np.testing.assert_array_equal(t.numpy() == 0, ref == 0, err_msg=name)
        for key in ("fc_w", "fc2_w", "qkv_w"):
            port = np.stack([tparams[f"blocks.{i}.{key}"].numpy() for i in range(2)])
            for stacked in (port, jparams["blocks"][key]):
                levels, zeros, ties = _levels_and_zeros(stacked)
                assert levels <= 2 ** 6
                # dense ratio 0.5 on the quantized values: half pruned, less
                # the ties at the threshold, which are kept
                if key.startswith("fc"):
                    assert 0.5 - ties <= zeros <= 0.5
        return
    np.testing.assert_allclose(engine_runs["tl"][6], engine_runs["jl"][6], rtol=1e-5)
    lr = ENGINE_CFG["optimizer"]["params"]["lr"]
    for name, t in tparams.items():
        moved = np.abs(t.numpy() - tclean[name].numpy()).max()
        jmoved = np.abs(_jax_leaf(jparams, name) - _jax_leaf(jclean, name)).max()
        assert moved <= 4 * lr and jmoved <= 4 * lr, (name, moved, jmoved)


def test_compression_refuses_stage_3():
    """Stage 3 with a partitioned unit no longer refuses compression: the
    engine arms it, its compressed gatherer serves the fetched units'
    armed weights through the ZeRO state's gathers, and a step trains
    (``test_torch_compression_zero3.py`` holds it to JAX and to stage 1).
    What still refuses is ``offload_param: nvme``, the layerwise
    ZeRO-Infinity engine."""
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32)),
        device="cpu", config={**ENGINE_CFG, "zero_optimization": {
            "stage": 3, "stage3_param_persistence_threshold": 0}})
    assert all(engine._zero.fetched) and engine._compressed.zero is engine._zero
    assert np.isfinite(float(engine.train_batch({"input_ids": np.zeros((8, 16), np.int32)})))
    with pytest.raises(NotImplementedError, match="compression_training"):
        deepspeed_tpu_torch.initialize(
            model=tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32)),
            device="cpu", config={**ENGINE_CFG, "zero_optimization": {
                "stage": 3, "offload_param": {"device": "nvme"}}})
