"""Compression training at the port's placements, held to one another.

The same small GPT-2, weights and batch as ``test_torch_compression_zero3.py``
(whose constants and engine runner this file uses), at stage 1, at stage 3
with the weights fetched and under ``offload_param: cpu``:

* pruning the fc leaves alone, or the qkv weights alone, leaves the rest
  of each block's unit unarmed, ahead of them or behind them, and the
  unit's gathers hand out those parameters' updated raw values: stage 3
  and ``offload_param`` equal stage 1 bit for bit;
* the eigenvalue reads whole raw copies of the weights at stage 3 and under
  ``offload_param`` and gives stage 1's estimates and losses bit for bit;
* ``offload_param: nvme`` (the layerwise ZeRO-Infinity engine) refuses
  compression and the eigenvalue.
"""

import pytest
import torch

from tests.test_torch_compression_zero3 import BLOCK, CONFIG, PLACEMENTS, SMALL, _batch, _run

EIGEN = {"enabled": True, "max_iter": 2, "tol": 1e-2, "gas_boundary_resolution": 1}
PRUNE_FC = {"sparse_pruning": BLOCK["sparse_pruning"]}


def _placements_train_alike(monkeypatch, block):
    """Five steps under ``block`` at every placement equal stage 1's bit
    for bit, losses and params, with some unit served. ``torch.empty``
    hands out NaN-filled floats here, so a stretch of a gathered buffer
    that no copy writes shows, whatever memory the allocator reuses."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2 as tgpt2

    empty = torch.empty

    def poisoned(*args, **kwargs):
        t = empty(*args, **kwargs)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    monkeypatch.setattr(torch, "empty", poisoned)
    state = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32)).init_params(
        torch.Generator().manual_seed(7)).state_dict()
    got = {}
    for name, (zero, _) in PLACEMENTS.items():
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32)),
            config={**CONFIG, "compression_training": block, "zero_optimization": zero},
            device="cpu", model_parameters={k: v.clone() for k, v in state.items()})
        losses = [float(engine.train_batch(_batch())) for _ in range(5)]
        got[name] = (losses, {k: v.clone() for k, v in engine.module_state_dict().items()},
                     len(engine._zero.served))
    assert got["stage3"][2] and got["stage3_offload"][2]
    for name in ("stage3", "stage3_offload"):
        assert got[name][0] == got["stage1"][0], name
        for k, t in got[name][1].items():
            assert torch.equal(t, got["stage1"][1][k]), (name, k)


def test_unarmed_params_of_a_served_unit_follow_their_updates(monkeypatch):
    """Pruning the fc leaves alone leaves the rest of each block's unit
    unarmed, ahead of them: the unit's gathers must hand out their updated
    raw values beside the served ones (``ZeroState._copy_served``), so
    stage 3 and ``offload_param`` still equal stage 1 bit for bit."""
    _placements_train_alike(monkeypatch, PRUNE_FC)


def test_unarmed_tail_of_a_served_unit_follows_its_updates(monkeypatch):
    """Pruning the qkv weights alone, the first of each block's unit, leaves
    the rest of the unit unarmed behind it: stage 3 and ``offload_param``
    still equal stage 1 bit for bit."""
    block = {"sparse_pruning": {**PRUNE_FC["sparse_pruning"], "different_groups": {
        "g": {"params": {"dense_ratio": 0.5}, "modules": ["blocks/qkv"]}}}}
    _placements_train_alike(monkeypatch, block)


def test_eigenvalue_reads_whole_raw_weights_at_every_placement():
    """With the eigenvalue block, stage 3 and ``offload_param`` estimate
    each layer's eigenvalue from whole raw copies of the weights and give
    stage 1's estimates and losses bit for bit."""
    from deepspeed_tpu_torch.models import gpt2 as tgpt2

    state = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32)).init_params(
        torch.Generator().manual_seed(5)).state_dict()
    got = {name: _run(state, zero, steps=1, extra={"eigenvalue": EIGEN})
           for name, (zero, _) in PLACEMENTS.items()}
    assert got["stage1"]["eigen"] and all(0 < ev <= 1 for ev, _ in
                                          got["stage1"]["eigen"].values())
    for name in ("stage3", "stage3_offload"):
        assert got[name]["eigen"] == got["stage1"]["eigen"], name
        assert got[name]["losses"] == got["stage1"]["losses"], name


def test_offload_param_nvme_still_refuses_compression(tmp_path):
    """``offload_param: nvme`` is the layerwise ZeRO-Infinity engine, which
    has no gatherer to serve compressed values through: it refuses the
    block, and the eigenvalue block, instead of training uncompressed."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2 as tgpt2

    zero = {"stage": 3, "offload_param": {"device": "nvme", "nvme_path": str(tmp_path)}}
    plain = {k: v for k, v in CONFIG.items() if k != "compression_training"}
    for config, block in ((CONFIG, "compression_training"),
                          ({**plain, "eigenvalue": EIGEN}, "eigenvalue")):
        with pytest.raises(NotImplementedError, match=block):
            deepspeed_tpu_torch.initialize(
                model=tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32)),
                config={**config, "zero_optimization": zero}, device="cpu")
