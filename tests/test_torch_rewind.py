"""The port's rewind ladder against the JAX package's ``test_rewind.py``
cases, on the CPU with SimpleModel (world 1, global batch 8).

The RAM ring's cadence and bound; a bitwise restore; the ladder taking the
fresher of RAM and disk both ways; the sentinel rewinding from RAM with no
disk; bad steps never entering the ring; an emergency tag beating a stale
``latest``, and skipped without the block; a step that stopped half way
refusing the next until a restore; and, without the blocks, no module of
theirs imported and no thread started. The kill and preempt drills, run
on both packages, are in ``tests/test_torch_rewind_drills.py``.
"""

import json
import os
import signal
import sys
import threading

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import simple as tsimple
from deepspeed_tpu_torch.resilience import chaos as tchaos
from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (flatten_state,
                                                                   wait_for_pending_saves)

HIDDEN, LAYERS = 16, 2
CFG = {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
       "steps_per_print": 0}
NEW_MODULES = ("deepspeed_tpu_torch.resilience.rewind", "deepspeed_tpu_torch.resilience.sentinel",
               "deepspeed_tpu_torch.resilience.consistency", "deepspeed_tpu_torch.elasticity",
               "deepspeed_tpu_torch.elasticity.elastic_agent")


@pytest.fixture(autouse=True)
def _clean_slate():
    """Fresh chaos, a fresh ring, the signal handlers as they were."""
    orig = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    tchaos.uninstall_chaos()
    for name in ("deepspeed_tpu_torch.resilience.rewind", "deepspeed_tpu.resilience.rewind"):
        mod = sys.modules.get(name)
        if mod is not None:
            mod.clear_ram_snapshots()
    if "deepspeed_tpu.resilience.chaos" in sys.modules:
        sys.modules["deepspeed_tpu.resilience.chaos"].uninstall_chaos()
    for s, h in orig.items():
        signal.signal(s, h)


def make_engine(rewind=None, extra=None, params=None):
    cfg = dict(CFG)
    if rewind is not None:
        cfg["rewind"] = rewind
    cfg.update(extra or {})
    model = tsimple.SimpleModel(HIDDEN, LAYERS)
    if params is None:
        model.init_params(torch.Generator().manual_seed(0))
    else:
        model = tsimple.params_from_jax(params, HIDDEN, LAYERS)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    return engine


def batch(seed=0, bad=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(8, HIDDEN).astype(np.float32)
    y = rng.randn(8, HIDDEN).astype(np.float32)
    if bad:
        x[0, 0] = np.nan
    return (x, y)


def state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def ring():
    from deepspeed_tpu_torch.resilience import rewind as rw

    return [s.step for s in rw.ram_snapshots()]


# ------------------------------------------------------------ strict no-op
@pytest.mark.parametrize("rewind", [None, {"enabled": False}])
def test_blocks_absent_import_nothing_and_start_nothing(tmp_path, rewind):
    saved = {m: sys.modules.pop(m) for m in list(sys.modules) if m in NEW_MODULES}
    try:
        engine = make_engine(rewind=rewind)
        engine.train_batch(batch())
        before = threading.active_count()
        engine.train_batch(batch())
        engine.save_checkpoint(str(tmp_path))
        engine.load_checkpoint(str(tmp_path))
        assert engine._rewind is None and engine._watchdog is None
        assert engine._bad_step_sentinel is None and engine._heartbeat_path is None
        assert not [m for m in NEW_MODULES if m in sys.modules]
        assert threading.active_count() <= before
        from deepspeed_tpu_torch.comm import comm

        assert comm._default_barrier_timeout is None
    finally:
        sys.modules.update(saved)


# ------------------------------------------------------------- tier-0 ring
def test_ring_cadence_and_bound():
    engine = make_engine(rewind={"ram_interval": 2, "keep": 2})
    for _ in range(7):
        engine.train_batch(batch())
    assert ring() == [4, 6]                      # bounded to keep=2
    from deepspeed_tpu_torch.resilience import rewind as rw

    # the slots were reserved at the engine's init and are reused
    assert engine._rewind.reserved_bytes == 2 * rw.ram_snapshots()[0].nbytes


def test_restore_roundtrip_bitwise():
    engine = make_engine(rewind={"ram_interval": 2, "keep": 1})
    for _ in range(4):
        engine.train_batch(batch())
    want = flatten_state(engine)
    engine.train_batch(batch(seed=1))
    assert engine.global_steps == 5
    info = engine._rewind.restore_from_ram()
    assert info["tier"] == "ram" and info["snapshot_step"] == 4
    assert engine.global_steps == 4
    state_equal(flatten_state(engine), want)
    assert np.isfinite(float(engine.train_batch(batch())))
    assert engine.global_steps == 5 and ring() == [4]


def test_ladder_prefers_fresher_disk(tmp_path):
    engine = make_engine(rewind={"ram_interval": 3, "keep": 1})
    for _ in range(4):
        engine.train_batch(batch())              # RAM snapshot at 3 only
    engine.save_checkpoint(str(tmp_path))        # disk tag at 4 (newer)
    path, _ = engine.load_checkpoint(str(tmp_path))
    assert not str(path).startswith("ram://")
    assert engine.global_steps == 4 and engine._last_recovery["tier"] == "disk"


def test_ladder_prefers_ram_over_equal_or_stale_disk(tmp_path):
    engine = make_engine(rewind={"ram_interval": 1, "keep": 1})
    for _ in range(2):
        engine.train_batch(batch())
    engine.save_checkpoint(str(tmp_path))        # disk at 2
    engine.train_batch(batch())                  # RAM snapshot at 3 (newer)
    path, _ = engine.load_checkpoint(str(tmp_path))
    assert str(path) == "ram://step3"
    assert engine.global_steps == 3 and engine._last_recovery["tier"] == "ram"


# ------------------------------------------------- the sentinel and the ladder
def test_sentinel_rewinds_from_ram_without_any_disk_checkpoint(tmp_path):
    from deepspeed_tpu_torch import telemetry

    engine = make_engine(rewind={"ram_interval": 1, "keep": 2}, extra={
        "resilience": {"sentinel": {"enabled": True, "patience": 2}},
        "telemetry": {"enabled": True, "output_dir": str(tmp_path), "jsonl": False,
                      "prometheus": False, "trace": False}})
    try:
        for _ in range(3):
            engine.train_batch(batch())
        assert engine._ckpt_save_dir is None
        engine.train_batch(batch(bad=True))
        engine.train_batch(batch(bad=True))      # patience 2: rewind
        assert engine._sentinel_rewinds == 1
        assert engine.global_steps == 3 and engine._rewind.last_recovery["tier"] == "ram"
        tiers = {tuple(sorted(r["labels"].items())): r["value"]
                 for r in telemetry.get_registry().snapshot()
                 if r["name"] == "resilience/sentinel_rewinds"}
        assert tiers == {(("tier", "ram"),): 1}
        assert np.isfinite(float(engine.train_batch(batch())))
    finally:
        telemetry.deconfigure()


def test_bad_steps_never_enter_the_ring():
    engine = make_engine(rewind={"ram_interval": 1, "keep": 8},
                         extra={"resilience": {"sentinel": {"enabled": True, "patience": 3}}})
    engine.train_batch(batch())
    engine.train_batch(batch(bad=True))
    assert ring() == [1]


def test_sentinel_without_anything_still_raises():
    from deepspeed_tpu_torch.resilience.sentinel import BadStepError

    engine = make_engine(rewind={"ram_interval": 100},
                         extra={"resilience": {"sentinel": {"enabled": True, "patience": 1}}})
    with pytest.raises(BadStepError, match="nothing"):
        engine.train_batch(batch(bad=True))


def test_half_finished_step_refuses_until_a_restore(monkeypatch):
    """A fault inside the step (after the first launch) leaves the state
    half updated: the engine refuses the next step; a ladder restore (here
    the RAM tier) brings it back."""
    engine = make_engine(rewind={"ram_interval": 1, "keep": 1})
    engine.train_batch(batch())
    want = flatten_state(engine)

    def fault(*a, **k):
        raise OSError("device lost mid-update")

    monkeypatch.setattr(engine, "_apply_grads", fault)
    with pytest.raises(OSError):
        engine.train_batch(batch())
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="did not finish"):
        engine.train_batch(batch())
    path, _ = engine.load_checkpoint("/nonexistent-dir")   # the RAM tier serves it
    assert path == "ram://step1"
    state_equal(flatten_state(engine), want)
    assert np.isfinite(float(engine.train_batch(batch())))


@pytest.mark.parametrize("where,broken", [("_forward", False), ("_backward", True),
                                          ("_apply_grads", True)])
def test_fault_without_blocks_refuses_only_from_the_first_backward(monkeypatch, where,
                                                                    broken):
    """Without any resilience block: a fault in a forward (an out-of-memory,
    say) leaves the state as it was, and the retried step equals an
    unfaulted engine's; one from the first backward on makes the engine
    refuse the next step."""
    engine, ref = make_engine(), make_engine()
    engine.train_batch(batch())
    ref.train_batch(batch())

    def fault(*a, **k):
        raise RuntimeError("out of memory (simulated)")

    monkeypatch.setattr(engine, where, fault)
    with pytest.raises(RuntimeError, match="out of memory"):
        engine.train_batch(batch(1))
    monkeypatch.undo()
    if broken:
        with pytest.raises(RuntimeError, match="did not finish"):
            engine.train_batch(batch(1))
        return
    engine.train_batch(batch(1))
    ref.train_batch(batch(1))
    assert engine.global_steps == ref.global_steps == 2
    state_equal(flatten_state(engine), flatten_state(ref))


# ------------------------------------------------------ tier-1 and the ladder
def test_emergency_tag_beats_stale_latest(tmp_path):
    from deepspeed_tpu_torch.resilience import rewind as rw
    from deepspeed_tpu_torch.resilience.manifest import candidate_tags, verify_tag

    save = str(tmp_path / "ckpt")
    engine = make_engine(rewind={"ram_interval": 1, "keep": 1})
    for _ in range(2):
        engine.train_batch(batch())
    engine.save_checkpoint(save)                 # ordinary tag at 2, and latest
    for _ in range(3):
        engine.train_batch(batch())
    tag = engine._rewind.emergency_save(save)    # a fresh snapshot at 5
    assert tag == "emergency_step5"
    wait_for_pending_saves()                     # the step-2 save's async commit
    tag_dir = os.path.join(save, tag)
    assert verify_tag(tag_dir)[0]
    with open(os.path.join(save, "latest")) as f:
        assert f.read().strip() == "global_step2"    # not advanced
    manifest = json.load(open(os.path.join(tag_dir, "manifest.json")))
    meta = json.load(open(os.path.join(tag_dir, "client_state.json")))
    assert manifest["advance_latest"] is True and "state/rewind_state.npz" in manifest["files"]
    assert meta["format"] == "ds_rewind_npz" and meta["rewind"]["steps_lost_at_save"] == 0
    assert {sm["dtype"] for sm in meta["state_meta"].values()} >= {"float32", "int64"}
    assert candidate_tags(save)[0] == tag
    want = flatten_state(engine)

    rw.clear_ram_snapshots()                     # a new process
    engine2 = make_engine(rewind={"ram_interval": 1})
    path, _ = engine2.load_checkpoint(save)
    assert path.endswith("emergency_step5") and engine2.global_steps == 5
    assert engine2._last_recovery["tier"] == "emergency"
    assert engine2._last_recovery["steps_lost"] == 0
    state_equal(flatten_state(engine2), want)
    assert np.isfinite(float(engine2.train_batch(batch())))


def test_emergency_tag_ignored_without_block(tmp_path):
    from deepspeed_tpu_torch.resilience import rewind as rw

    save = str(tmp_path / "ckpt")
    engine = make_engine(rewind={"ram_interval": 1})
    engine.train_batch(batch())
    engine.save_checkpoint(save)
    engine.train_batch(batch())
    engine._rewind.emergency_save(save)
    rw.clear_ram_snapshots()
    engine2 = make_engine()
    path, _ = engine2.load_checkpoint(save)
    assert os.path.basename(path) == "global_step1" and engine2.global_steps == 1


def test_truncated_emergency_tag_falls_back(tmp_path):
    """A chaos truncation of the streamed payload: the tag fails its
    manifest and the ladder takes the ordinary tag."""
    from deepspeed_tpu_torch.resilience import rewind as rw

    save = str(tmp_path / "ckpt")
    engine = make_engine(rewind={"ram_interval": 1})
    engine.train_batch(batch())
    engine.save_checkpoint(save)
    engine.train_batch(batch())
    tchaos.install_chaos(tchaos.ChaosInjector(truncate_at={"emergency_save": [2]}))
    assert engine._rewind.emergency_save(save) == "emergency_step2"
    tchaos.uninstall_chaos()
    rw.clear_ram_snapshots()
    engine2 = make_engine(rewind={"ram_interval": 1})
    path, _ = engine2.load_checkpoint(save)
    assert os.path.basename(path) == "global_step1"


def _flip_payload_byte(tag_dir):
    """Flip one byte in the middle of the payload's largest entry's data."""
    import struct
    import zipfile

    path = os.path.join(tag_dir, "state", "rewind_state.npz")
    with zipfile.ZipFile(path) as zf:
        info = max(zf.infolist(), key=lambda i: i.file_size)
    with open(path, "r+b") as f:
        f.seek(info.header_offset + 26)
        name_len, extra_len = struct.unpack("<HH", f.read(4))
        at = info.header_offset + 30 + name_len + extra_len + info.file_size - 8
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("verify_on_load", [True, False])
@pytest.mark.parametrize("corrupt", [False, True])
def test_corrupt_emergency_payload_is_skipped(tmp_path, verify_on_load, corrupt):
    """One byte of the payload flipped: with ``verify_on_load`` the
    manifest's sha256 rejects the tag, without it the entries' CRC-32; the
    ladder takes the ordinary tag. Intact, the tag restores either way."""
    from deepspeed_tpu_torch.resilience import rewind as rw

    save = str(tmp_path / "ckpt")
    extra = {"resilience": {"verify_on_load": verify_on_load}}
    engine = make_engine(rewind={"ram_interval": 1}, extra=extra)
    engine.train_batch(batch())
    engine.save_checkpoint(save)
    engine.train_batch(batch())
    tag = engine._rewind.emergency_save(save)
    wait_for_pending_saves()
    want = flatten_state(engine)
    if corrupt:
        _flip_payload_byte(os.path.join(save, tag))
    rw.clear_ram_snapshots()
    engine2 = make_engine(rewind={"ram_interval": 1}, extra=extra)
    path, _ = engine2.load_checkpoint(save)
    if corrupt:
        assert os.path.basename(path) == "global_step1" and engine2.global_steps == 1
    else:
        assert os.path.basename(path) == tag and engine2._last_recovery["tier"] == "emergency"
        state_equal(flatten_state(engine2), want)
