"""The consistency guard and the rewind ladder over a gloo world of two
spawned ranks on the CPU.

The startup fingerprint: a rank with another config raises ``DesyncError``
naming itself before its first step. The step agreement: a rank whose loss
differs by one bit is named by every rank, with the majority vote of JAX's
``find_divergent`` over the same rows. The ladder: the two ranks train
SimpleModel with the ``rewind`` block (ZeRO stage 1, so the snapshot's
capture gathers the partitions), save a tag and an emergency tag; a world
of one then loads the save directory: the emergency tag and a RAM snapshot
of the two-rank world degrade loudly to the verified disk tag.
"""

import os

import numpy as np
import pytest

from tests.torch_world import World

HIDDEN, LAYERS = 16, 2
CFG = {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
       "zero_optimization": {"stage": 1}, "steps_per_print": 0}


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(8, HIDDEN).astype(np.float32), rng.randn(8, HIDDEN).astype(np.float32))


def _ranks(rank, world, out_dir):
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import simple as tsimple
    from deepspeed_tpu_torch.resilience import consistency as cons

    out = {}
    try:
        cons.verify_startup_consistency({"lr": 1e-3 if rank == 0 else 2e-3}, timeout=30.0)
        out["startup"] = None
    except cons.DesyncError as e:
        out["startup"] = str(e)
    out["agree"] = cons.check_step_agreement(3, 1.25, rng=np.int64(7))
    try:
        loss = np.float32(1.25) if rank == 0 else np.nextafter(np.float32(1.25), np.float32(2))
        cons.check_step_agreement(4, float(loss), rng=np.int64(7))
        out["diverge"] = None
    except cons.DesyncError as e:
        out["diverge"] = str(e)
    out["rows"] = cons._gather_rows(cons.step_digest(5, 1.0 + rank, b""))

    save = os.path.join(out_dir, "ckpt")
    model = tsimple.SimpleModel(HIDDEN, LAYERS).init_params(torch.Generator().manual_seed(0))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, config={**CFG, "rewind": {"ram_interval": 1, "keep": 1},
                             "watchdog": {"enabled": True, "consistency_interval": 1}},
        device="cpu")
    x, y = _batch()
    mine = (x[rank::world], y[rank::world])
    for _ in range(2):
        eng.train_batch(mine)
    eng.save_checkpoint(save)
    eng.train_batch(mine)
    out["tag"] = eng._rewind.emergency_save(save)
    out["world"] = eng._rewind.newest().world
    eng._watchdog.close()
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import wait_for_pending_saves

    wait_for_pending_saves()            # rank 0's async commit, before the process ends
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("resilience_world"))
    return World(_ranks, 2, out_dir).join(), out_dir


def test_startup_fingerprint_names_the_rank_with_another_config(runs):
    ranks, _ = runs
    assert ranks[0]["startup"] is None
    assert "rank 1" in ranks[1]["startup"] and "fingerprint" in ranks[1]["startup"]


def test_step_agreement_names_the_divergent_rank_as_jax_votes(runs):
    from deepspeed_tpu.resilience import consistency as jcons
    from deepspeed_tpu_torch.resilience import consistency as tcons

    ranks, _ = runs
    assert ranks[0]["agree"] == ranks[1]["agree"]
    for r in ranks:
        assert "rank(s) [1]" in r["diverge"]
    rows = ranks[0]["rows"]
    assert rows.shape == (2, 33) and (rows[:, 0] == tcons.PROTO_VERSION).all()
    assert tcons.find_divergent(rows[:, 1:]) == jcons.find_divergent(rows[:, 1:]) == [1]
    three = np.concatenate([rows, rows[:1]])
    assert tcons.check_row_agreement(three, 5) == jcons.check_row_agreement(three, 5) == [1]
    mixed = three.copy()
    mixed[2, 0] = 1
    with pytest.raises(tcons.DesyncError, match="kind=proto"):
        tcons.check_row_agreement(mixed, 5)


def test_a_two_rank_snapshot_degrades_loudly_to_disk_at_world_one(runs, caplog):
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import simple as tsimple
    from deepspeed_tpu_torch.resilience import rewind as rw
    from deepspeed_tpu_torch.utils.logging import logger

    ranks, out_dir = runs
    save = os.path.join(out_dir, "ckpt")
    assert ranks[0]["tag"] == "emergency_step3" and ranks[0]["world"]["dp_world_size"] == 2
    assert sorted(os.listdir(save)) == ["emergency_step3", "global_step2", "latest"]

    def engine():
        model = tsimple.SimpleModel(HIDDEN, LAYERS).init_params(torch.Generator().manual_seed(1))
        return deepspeed_tpu_torch.initialize(
            model=model, config={**CFG, "rewind": {"ram_interval": 1}}, device="cpu")[0]

    try:
        # a RAM snapshot of the two-rank world in this process's ring
        other = engine()
        other.train_batch(_batch())
        rw.ram_snapshots()[-1].world = dict(ranks[0]["world"])
        logger.propagate = True
        with caplog.at_level("WARNING", logger=logger.name):
            eng = engine()
            path, _ = eng.load_checkpoint(save)
    finally:
        logger.propagate = False
        rw.clear_ram_snapshots()
    assert os.path.basename(path) == "global_step2" and eng.global_steps == 2
    assert eng._last_recovery["tier"] == "disk"
    text = caplog.text
    assert "RAM snapshot @step 1 unusable (world changed" in text
    assert "emergency tag 'emergency_step3' was captured on a different world" in text
    assert "disk tier" in text
