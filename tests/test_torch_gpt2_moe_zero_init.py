"""The MoE GPT-2 under ``zero.Init``, in the port against the JAX engine,
on the CPU; and the MoE refusals that stay.

``zero.materialize`` draws a MoE model unit by unit in its stage-3
placement, the expert banks as the dense units, with the whole tree's
values; the engine adopts it, and three steps (gas 2, a loss mask) match
the JAX engine given the same values at 1e-4. ZeRO-Infinity of a MoE model
and a MoE config with dropout still raise, with the reference's fault as
the reason.
"""

import functools

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2_moe as tmoe
from deepspeed_tpu_torch.runtime import zero
from deepspeed_tpu_torch.runtime.zero.state import PARAMS
from tests.test_torch_gpt2_moe import E, GAS, ROWS, _batch, _jax_leaf, _jax_params, _port, _tcfg
from tests.test_torch_gpt2_moe_offload import _config, _jax_losses, _port_losses, _tree_from_port


def test_zero_init_moe_trains_like_the_jax_engine():
    seed = 13
    build = functools.partial(tmoe.MoEGPT2, _tcfg(), num_experts=E, capacity_factor=1.0)
    with zero.Init(config=_config(3), device="cpu"):
        model = build()
        state = zero.materialize(model, torch.Generator().manual_seed(seed))
    whole = build().init_params(
        torch.Generator().manual_seed(seed)).state_dict()
    # the expert banks drawn in their placement hold the whole tree's values
    held = dict(zip([n for n, _ in model.named_parameters()], state.to_host(PARAMS)))
    for name in ("moe.0.experts.wi", "moe.1.gate.wg", "blocks.2.qkv_w"):
        assert torch.equal(held[name], whole[name]), name
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=_config(3), device="cpu")
    assert model.param_gatherer is engine._zero
    params = _tree_from_port(whole)
    np.testing.assert_array_equal(_jax_leaf(params, "moe.1.experts.wi"),
                                  whole["moe.1.experts.wi"].numpy())
    batch = _batch(ROWS * GAS, seed=seed, mask=True)
    ref_losses, ref_norm = _jax_losses(params, _config(3), batch)
    losses, norm = _port_losses(engine, batch)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert norm == pytest.approx(ref_norm, rel=1e-4)


def test_infinity_and_dropout_of_a_moe_model_still_raise(tmp_path):
    params = _jax_params(seed=15)
    with pytest.raises(NotImplementedError, match="MoE"):
        deepspeed_tpu_torch.initialize(
            model=_port(params),
            config=_config(3, offload_param={"device": "nvme", "nvme_path": str(tmp_path)}),
            device="cpu")
    with pytest.raises(NotImplementedError, match="silently trains without dropout"):
        tmoe.MoEGPT2(_tcfg(dropout=0.1), num_experts=E)
