"""The rewind ladder: tiered in-memory snapshots and recovery that loses
seconds of work, not a checkpoint interval.

Counterpart of ``deepspeed_tpu/resilience/rewind.py``, with the same tiers,
tag layout and recovery record:

* **tier 0, the host-RAM ring.** Every ``ram_interval`` healthy steps the
  whole state (params, fp32 masters, optimizer moments, loss scaler,
  counters) is copied to host memory with the host-side progress facts a
  checkpoint's ``client_state.json`` records (the LR schedule, the sampler,
  the dataloader's position), into a ring of ``keep`` snapshots that never
  touches disk. The ring is process-wide, so an in-process restart (the
  elastic agent's after a failed or hung step, the sentinel's rewind)
  restores from it. Each ring entry owns one host slab, page-locked
  (``ops.aio.host_zeros``) for an engine on the card (so the copies run at the
  host link's rate), allocated once: the manager reserves ``keep`` of them
  when it is built (a pool the ring's entries and the free slots share),
  and the snapshot that replaces the oldest entry reuses its slab;
  :func:`clear_ram_snapshots` releases them all. The copy is synchronous:
  the next step's optimizer updates the state in place.
* **tier 1, the emergency save.** On preemption the elastic agent flushes
  a snapshot (a fresh one with ``emergency_fresh``) as an
  ``emergency_step<N>`` tag: ``state/_CHECKPOINT_METADATA``,
  ``state/rewind_state.npz`` (each tensor as its raw bytes, ``uint8``, its
  shape and torch dtype in ``client_state.json``'s ``state_meta``),
  ``client_state.json`` with a ``rewind`` record, and the manifest last,
  ``advance_latest: true``, so ``candidate_tags`` ranks the tag by its
  step, while the ``latest`` file is not written. The npz is streamed to
  disk while its sha256 is taken (the JAX module builds it in memory), so
  the save holds no second copy of the state.
* **tier 2**: the ordinary verified checkpoint.

A load walks the ladder (``runtime/checkpoint_engine/engine.py``); every
recovery stamps ``engine._last_recovery = {tier, snapshot_step,
steps_lost, restore_s}`` and the ``rewind/*`` series. A snapshot on another
world degrades loudly to the disk tier. The manager refuses an engine whose
state lives in files (the NVMe optimizer, ZeRO-Infinity), as JAX refuses
its NVMe optimizer.

This module is imported only with an enabled ``rewind`` block; without it
there is no ring, no host copy and no thread.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (
    REWIND_STATE_FILE, apply_flat_state, apply_restored_meta, capture_host_meta,
    copy_state_into, host_state_layout, model_layout, world_signature)
from deepspeed_tpu_torch.utils import locks as _locks
from deepspeed_tpu_torch.utils.logging import log_dist, logger

EMERGENCY_PREFIX = "emergency_step"
# the rewind/last_recovery_tier gauge's codes
TIER_CODES = {"none": 0, "ram": 1, "emergency": 2, "disk": 3}
_ALIGN = 64


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class HostSlot:
    """One ring entry's host memory: a slab laid out as a state layout
    (:func:`host_state_layout`), each key a typed view at a 64-byte aligned
    offset. Page-locked when ``pin`` (released when the slot dies)."""

    def __init__(self, layout: Mapping[str, Tuple[tuple, torch.dtype]], pin: bool):
        from deepspeed_tpu_torch.ops.aio import host_zeros

        self.layout = dict(layout)
        offsets, total = {}, 0
        for key, (shape, dtype) in self.layout.items():
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            offsets[key] = (total, n)
            total += -(-n // _ALIGN) * _ALIGN
        self.nbytes = total
        self.slab = host_zeros(total, pin=pin)
        self.pinned = self.slab.is_pinned()
        self.raw = {k: self.slab[o:o + n] for k, (o, n) in offsets.items()}
        self.flat = {k: self.raw[k].view(dtype).view(shape)
                     for k, (shape, dtype) in self.layout.items()}


class RamSnapshot:
    """One tier-0 snapshot: the state in its slot, the host-side progress
    facts of the same instant, the world signature the restore checks, and
    the checkpoint directory of the run at capture (None when it never saved
    or loaded: a snapshot serves only loads of its own directory)."""

    __slots__ = ("step", "slot", "meta", "world", "ckpt_dir", "wall_ts", "nbytes",
                 "capture_s")

    def __init__(self, step: int, slot: HostSlot, meta: dict, world: dict,
                 ckpt_dir: Optional[str] = None, capture_s: float = 0.0):
        self.step = int(step)
        self.slot = slot
        self.meta = meta
        self.world = world
        self.ckpt_dir = ckpt_dir
        self.wall_ts = time.time()
        self.nbytes = slot.nbytes
        self.capture_s = capture_s

    @property
    def flat(self) -> Dict[str, torch.Tensor]:
        return self.slot.flat


# Process-wide on purpose: an in-process restart tears the engine down and
# builds another, and the snapshots must outlive that. Its validity is one
# supervised run: DSElasticAgent clears it when the run completes or is
# preempted; a caller training without the agent clears it itself.
_RING: List[RamSnapshot] = []
# reserved slots no snapshot holds yet
_FREE: List[HostSlot] = []
# the capture runs on the training thread while the emergency flush and the
# agent walk the ring from others
_RING_LOCK = _locks.make_lock("rewind.ring")


def ram_snapshots() -> List[RamSnapshot]:
    """The tier-0 ring, oldest first (a copy of the list)."""
    with _RING_LOCK:
        return list(_RING)


def clear_ram_snapshots() -> None:
    """Drop the tier-0 ring and release its host memory (the reserved
    slots too)."""
    with _RING_LOCK:
        _RING.clear()
        _FREE.clear()


def reserve_slots(layout: Mapping[str, Tuple[tuple, torch.dtype]], n: int, pin: bool) -> int:
    """Make ``n`` slots of ``layout`` exist, in the ring or free, allocating
    what is missing (free slots of another layout are dropped: a run has one
    state). Returns the bytes allocated now."""
    layout = dict(layout)
    with _RING_LOCK:
        _FREE[:] = [s for s in _FREE if s.layout == layout]
        have = len(_FREE) + sum(1 for snap in _RING if snap.slot.layout == layout)
    made = [HostSlot(layout, pin) for _ in range(max(0, n - have))]
    with _RING_LOCK:
        _FREE.extend(made)
    return sum(s.nbytes for s in made)


def _take_slot(layout: dict, keep: int, pin: bool) -> HostSlot:
    """A slot for the next snapshot: the oldest entry's when the ring is
    full, else a reserved one, else a new one."""
    with _RING_LOCK:
        if len(_RING) >= keep and _RING[0].slot.layout == layout:
            return _RING.pop(0).slot
        for i, slot in enumerate(_FREE):
            if slot.layout == layout:
                return _FREE.pop(i)
    return HostSlot(layout, pin)


def _registry():
    from deepspeed_tpu_torch import telemetry

    return telemetry.get_registry()


def _same_world(a: Optional[dict], b: Optional[dict]) -> bool:
    """Two world signatures, after a JSON round trip's lists for tuples."""
    norm = lambda w: {**w, "mesh_shape": [list(x) for x in (w.get("mesh_shape") or [])]}
    return isinstance(a, dict) and isinstance(b, dict) and norm(a) == norm(b)


class RewindManager:
    """The engine's driver of the snapshot ladder (the ring itself is
    process-wide: see the module docstring)."""

    def __init__(self, engine, cfg):
        self.engine = engine
        self.cfg = cfg
        self.last_recovery: Optional[dict] = None
        self.last_emergency: Optional[dict] = None
        self._last_recovery_step: Optional[int] = None
        self._disabled_reason = None
        if getattr(engine, "_nvme_optimizer", None) is not None:
            # the fp32 master lives in the swap files: a host copy of the
            # card's state would pair fresh params with stale masters
            self._disabled_reason = ("NVMe-offloaded optimizer: the master state lives "
                                     "outside what a host copy of the engine sees")
        elif hasattr(engine, "flat_state"):
            self._disabled_reason = ("ZeRO-Infinity's layerwise engine keeps its state in "
                                     "files")
        self.reserve_s = 0.0
        self.reserved_bytes = 0
        if self._disabled_reason:
            logger.warning(f"rewind: tier-0/tier-1 snapshots disabled for this engine "
                           f"({self._disabled_reason}); restores use the verified disk tier")
            return
        # the ring's host memory, allocated (and page-locked) now rather than
        # inside a step
        t0 = time.perf_counter()
        self.reserved_bytes = reserve_slots(host_state_layout(engine), int(cfg.keep),
                                            pin=engine.device.type == "cuda")
        self.reserve_s = time.perf_counter() - t0

    # ------------------------------------------------------------ capture
    @property
    def active(self) -> bool:
        return self._disabled_reason is None

    @property
    def emergency_enabled(self) -> bool:
        return self.active and bool(self.cfg.emergency_save)

    def maybe_snapshot(self, step: int, metrics=None) -> bool:
        """The per-step hook, after the sentinel: a snapshot every
        ``ram_interval`` steps, never of a step the sentinel suspects (a
        ring of diverging states would rewind into the same cliff)."""
        if not self.active or step % self.cfg.ram_interval:
            return False
        if self._last_recovery_step == step:
            return False            # just restored at this step: the ring holds it
        if metrics is not None:
            import math

            if bool(metrics.overflow) or not math.isfinite(float(metrics.loss)):
                return False
        sentinel = getattr(self.engine, "_bad_step_sentinel", None)
        if sentinel is not None and sentinel.bad_streak > 0:
            return False
        self.snapshot_now(step)
        return True

    def snapshot_now(self, step: Optional[int] = None) -> RamSnapshot:
        """Capture a tier-0 snapshot now, between steps, into the slot of
        the entry it replaces when the ring is full, else a reserved one."""
        eng = self.engine
        if not self.active:
            raise RuntimeError(f"rewind disabled: {self._disabled_reason}")
        t0 = time.perf_counter()
        slot = _take_slot(host_state_layout(eng), int(self.cfg.keep),
                          pin=eng.device.type == "cuda")
        copy_state_into(eng, slot.flat)
        ckpt_dir = getattr(eng, "_ckpt_save_dir", None)
        snap = RamSnapshot(step=eng.global_steps if step is None else step, slot=slot,
                           meta=copy.deepcopy(capture_host_meta(eng)),
                           world=world_signature(eng),
                           ckpt_dir=os.path.abspath(ckpt_dir) if ckpt_dir else None,
                           capture_s=time.perf_counter() - t0)
        with _RING_LOCK:
            _RING.append(snap)
            del _RING[:-int(self.cfg.keep)]
            held = len(_RING)
            nbytes = sum(s.nbytes for s in _RING)
        reg = _registry()
        reg.counter("rewind/snapshots_taken").inc()
        reg.gauge("rewind/ram_snapshot_step").set(float(snap.step))
        reg.gauge("rewind/ram_snapshots_held").set(float(held))
        reg.gauge("rewind/ram_bytes").set(float(nbytes))
        reg.histogram("rewind/snapshot_s").observe(snap.capture_s)
        return snap

    def newest(self) -> Optional[RamSnapshot]:
        held = ram_snapshots()
        return held[-1] if held else None

    def has_ram_snapshot(self) -> bool:
        return self.active and bool(ram_snapshots())

    # ------------------------------------------------------------ restore
    def _snapshot_mismatch(self, snap: RamSnapshot) -> Optional[str]:
        world = world_signature(self.engine)
        if not _same_world(snap.world, world):
            return f"world changed (snapshot {snap.world} vs engine {world})"
        if snap.slot.layout != host_state_layout(self.engine):
            return "state structure changed (model/optimizer mismatch)"
        return None

    def restore_from_ram(self, min_step: Optional[int] = None,
                         for_dir: Optional[str] = None) -> Optional[dict]:
        """Restore the newest usable snapshot into the engine, in place.
        ``min_step``: only when it is at least this fresh (the ladder passes
        the best verified disk step). ``for_dir``: the load's directory; a
        snapshot of another is skipped (None: the sentinel rewinding its own
        run). Returns the recovery record, or None, loudly, when the ring is
        empty, stale, foreign or of another world."""
        if not self.active:
            return None
        eng = self.engine
        for_dir = os.path.abspath(for_dir) if for_dir else None
        for snap in reversed(ram_snapshots()):
            if for_dir is not None and snap.ckpt_dir is not None and snap.ckpt_dir != for_dir:
                logger.warning(f"rewind: RAM snapshot @step {snap.step} belongs to checkpoint "
                               f"dir {snap.ckpt_dir!r}, not the requested {for_dir!r}; "
                               "skipping it (disk tiers decide)")
                continue
            why = self._snapshot_mismatch(snap)
            if why:
                logger.warning(f"rewind: RAM snapshot @step {snap.step} unusable ({why}); "
                               "degrading to the verified disk tier")
                continue
            if min_step is not None and snap.step < min_step:
                log_dist(f"rewind: disk tier (step {min_step}) is fresher than the newest RAM "
                         f"snapshot (step {snap.step}); using disk", ranks=[0])
                return None
            t0 = time.perf_counter()
            apply_flat_state(eng, snap.flat)
            apply_restored_meta(eng, copy.deepcopy(snap.meta))
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)
            info = {"tier": "ram", "snapshot_step": snap.step, "steps_lost": None,
                    "restore_s": round(time.perf_counter() - t0, 4)}
            self.note_recovery(info)
            eng._last_recovery = info
            log_dist(f"rewind: restored RAM snapshot @step {snap.step} in "
                     f"{info['restore_s'] * 1e3:.1f}ms", ranks=[0])
            return info
        return None

    def note_recovery(self, info: dict) -> None:
        """Stamp a recovery of any tier into the telemetry and the
        manager's last-recovery slot."""
        self.last_recovery = dict(info)
        self._last_recovery_step = info.get("snapshot_step")
        reg = _registry()
        reg.counter("rewind/recoveries", labels={"tier": info.get("tier", "?")}).inc()
        reg.gauge("rewind/last_recovery_tier").set(float(TIER_CODES.get(info.get("tier"), 0)))
        for key in ("snapshot_step", "steps_lost", "restore_s"):
            if info.get(key) is not None:
                reg.gauge(f"rewind/last_recovery_{key}").set(float(info[key]))
        from deepspeed_tpu_torch import telemetry

        telemetry.get_tracer().instant("rewind_recovery", cat="resilience",
                                       **{k: v for k, v in info.items() if v is not None})
        bb = sys.modules.get("deepspeed_tpu_torch.blackbox")
        if bb is not None:
            bb.record("rewind_recovery", "info", {k: v for k, v in info.items() if v is not None},
                      step=info.get("snapshot_step"))

    # ---------------------------------------------------------- emergency
    def emergency_save(self, save_dir: str) -> Optional[str]:
        """Tier 1: flush a snapshot to ``save_dir`` as ``emergency_step<N>``
        (rank 0 writes; every rank takes part in a fresh capture). Returns
        the tag, or None when nothing could be flushed (the caller falls
        back to the ordinary checkpoint). ``last_emergency`` records the
        seconds, the payload's bytes and the capture's."""
        if not self.emergency_enabled:
            return None
        eng = self.engine
        t0 = time.perf_counter()
        snap = None
        if self.cfg.emergency_fresh:
            try:
                # at a stop boundary a fresh capture makes steps_lost 0
                snap = self.snapshot_now(step=eng.global_steps)
            except Exception as e:
                logger.warning(f"rewind: fresh emergency capture failed ({e}); flushing the "
                               "newest ring entry")
        if snap is None:
            snap = self.newest()
        if snap is None:
            logger.warning("rewind: emergency save requested but the tier-0 ring is empty — "
                           "nothing to flush")
            return None
        captured_at = int(eng.global_steps)
        tag = f"{EMERGENCY_PREFIX}{snap.step}"
        t_write = time.perf_counter()
        payload = 0
        if comm.get_rank() == 0:
            try:
                payload = write_emergency_tag(eng, save_dir, tag, snap,
                                              captured_at_step=captured_at)
            except Exception as e:
                logger.error(f"rewind: emergency save {tag!r} failed ({e}); falling back to "
                             "the ordinary checkpoint path")
                return None
        _registry().counter("rewind/emergency_saves").inc()
        self.last_emergency = {"tag": tag, "seconds": time.perf_counter() - t0,
                               "write_s": time.perf_counter() - t_write,
                               "capture_s": snap.capture_s if snap.step == captured_at else 0.0,
                               "payload_bytes": payload, "state_bytes": snap.nbytes,
                               "steps_lost_at_save": captured_at - snap.step}
        log_dist(f"rewind: emergency snapshot {tag} flushed to {save_dir} in "
                 f"{self.last_emergency['seconds']:.2f}s (steps_lost_at_save="
                 f"{captured_at - snap.step})", ranks=[0])
        return tag

    def load_emergency_tag(self, tag_dir: str, verified: bool = False):
        """A tier-1 tag's state, as the flat host tensors of
        :func:`host_state_layout`, and its metadata; ``(None, meta)``,
        loudly, when it was captured on another world or holds another
        state (the ladder then degrades to the disk tier). ``verified``:
        :func:`~deepspeed_tpu_torch.resilience.manifest.verify_tag` passed
        the tag, so when its manifest holds the payload's sha256 the bytes
        are known good and the zip's CRC-32 pass is skipped; otherwise each
        entry is checked against its CRC-32 as it is read."""
        eng = self.engine
        name = os.path.basename(tag_dir)
        with open(os.path.join(tag_dir, "client_state.json")) as f:
            meta = json.load(f)
        world = world_signature(eng)
        if not _same_world(meta.get("world"), world):
            logger.warning(f"rewind: emergency tag {name!r} was captured on a different world "
                           f"({meta.get('world')} vs {world}); degrading loudly to the verified "
                           "disk tier (the elasticity.resize knob would let this tier serve "
                           "it, a later slice of the port)")
            return None, meta
        state_meta = meta.get("state_meta") or {}
        layout = host_state_layout(eng)
        saved = {k: (tuple(sm["shape"]), sm["dtype"]) for k, sm in state_meta.items()}
        if saved != {k: (shape, _dtype_name(dt)) for k, (shape, dt) in layout.items()}:
            logger.warning(f"rewind: emergency tag {name!r} state keys or shapes do not match "
                           "this engine's; skipping")
            return None, meta
        hashed = verified and _payload_hashed(tag_dir)
        return _read_npz(os.path.join(tag_dir, REWIND_STATE_FILE), layout,
                         check_crc=not hashed), meta


def _payload_hashed(tag_dir: str) -> bool:
    """Does the tag's manifest hold the payload's sha256 (which
    ``verify_tag`` checks)? A tag without one was accepted on its commit
    marker alone."""
    from deepspeed_tpu_torch.resilience.manifest import MANIFEST_NAME

    try:
        with open(os.path.join(tag_dir, MANIFEST_NAME)) as f:
            files = json.load(f).get("files", {})
    except (OSError, ValueError):
        return False
    return "sha256" in (files.get(REWIND_STATE_FILE.replace(os.sep, "/")) or {})


def _read_npz(path: str, layout: Mapping[str, Tuple[tuple, torch.dtype]],
              check_crc: bool = True):
    """The emergency payload's entries (an npz of stored raw-byte arrays)
    read straight into host tensors of ``layout``, one read each, without
    the zip reader's copies. ``check_crc``: hold each entry to the zip's
    CRC-32, as ``np.load`` does (skipped when the manifest's sha256 has
    already checked the bytes)."""
    import struct
    import zipfile
    import zlib

    flat = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        entries = {info.filename.removesuffix(".npy"): info for info in zf.infolist()}
        for key, (shape, dtype) in layout.items():
            info = entries[key]
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: entry {key!r} is compressed")
            f.seek(info.header_offset + 26)          # the local header's name and extra
            name_len, extra_len = struct.unpack("<HH", f.read(4))
            start = info.header_offset + 30 + name_len + extra_len
            f.seek(start)
            version = np.lib.format.read_magic(f)
            header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                      else np.lib.format.read_array_header_2_0)
            (count,), _, stored = header(f)
            data_at = f.tell()
            raw = torch.empty(count, dtype=torch.uint8)
            if stored != np.uint8 or data_at - start + count != info.file_size \
                    or f.readinto(raw.numpy()) != count:
                raise ValueError(f"{path}: entry {key!r} is not {count} raw bytes")
            if check_crc:
                f.seek(start)
                crc = zlib.crc32(raw.numpy(), zlib.crc32(f.read(data_at - start)))
                if crc != info.CRC:
                    raise ValueError(f"{path}: entry {key!r} fails its CRC-32 (corrupt)")
            flat[key] = raw.view(dtype).view(shape)
    return flat


def write_emergency_tag(engine, save_dir: str, tag: str, snap: RamSnapshot,
                        captured_at_step: int) -> int:
    """The tier-1 flush, in the JAX order: the commit marker, the npz
    payload (streamed, hashed as written), the sampler sidecar,
    ``client_state.json``, the manifest last (``advance_latest`` true), no
    ``latest``. Every write passes the chaos hooks (op ``emergency_save``
    for the state). Returns the payload's bytes."""
    import io

    from deepspeed_tpu_torch.resilience.fsio import atomic_write_bytes, atomic_write_stream
    from deepspeed_tpu_torch.resilience.manifest import write_manifest
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import _retry_policy

    tag_dir = os.path.join(os.path.abspath(save_dir), tag)
    os.makedirs(os.path.join(tag_dir, "state"), exist_ok=True)
    policy = _retry_policy(engine)
    marker = json.dumps({"format": "ds_rewind_npz", "tag": tag}).encode()

    # the curriculum sampler's admitted order is an int64 array: a sidecar,
    # as the ordinary save writes it
    sampler_sd = snap.meta.get("data_sampler")
    admitted_bytes = None
    if sampler_sd is not None and isinstance(sampler_sd.get("admitted"), np.ndarray):
        sampler_sd = dict(sampler_sd)          # never mutate the snapshot
        abuf = io.BytesIO()
        np.save(abuf, sampler_sd.pop("admitted"))
        admitted_bytes = abuf.getvalue()
        sampler_sd["admitted_file"] = "data_sampler_admitted.npy"

    meta = {
        "tag": tag,
        "format": "ds_rewind_npz",
        "global_steps": snap.step,
        "skipped_steps": int(snap.flat["skipped_steps"]),
        "global_samples": snap.meta.get("global_samples", 0),
        "micro_steps": snap.meta.get("micro_steps", 0),
        "lr_scheduler": snap.meta.get("lr_scheduler"),
        "data_sampler": sampler_sd,
        "data_loader": snap.meta.get("data_loader"),
        "zero_stage": engine.zero_stage,
        "dp_world_size": engine.dp_world_size,
        "world": snap.world,
        "model_layout": model_layout(engine),
        "client_state": {},
        "rewind": {
            "tier": "emergency",
            "snapshot_step": snap.step,
            "captured_at_step": int(captured_at_step),
            "steps_lost_at_save": max(0, int(captured_at_step) - snap.step),
            "saved_wall_ts": time.time(),
        },
        # numpy has no bf16: the npz holds each tensor's raw bytes, and
        # (shape, torch dtype) ride here
        "state_meta": {k: {"shape": list(shape), "dtype": _dtype_name(dtype)}
                       for k, (shape, dtype) in snap.slot.layout.items()},
    }
    meta_bytes = json.dumps(meta, default=str).encode("utf-8")

    def write_npz(f):
        np.savez(f, **{k: raw.numpy() for k, raw in snap.slot.raw.items()})

    atomic_write_bytes(os.path.join(tag_dir, "state", "_CHECKPOINT_METADATA"), marker,
                       op="emergency_save", policy=policy)
    payload = atomic_write_stream(os.path.join(tag_dir, REWIND_STATE_FILE), write_npz,
                                  op="emergency_save", policy=policy)
    files = {"client_state.json": meta_bytes,
             REWIND_STATE_FILE.replace(os.sep, "/"): payload,
             "state/_CHECKPOINT_METADATA": marker}
    if admitted_bytes is not None:
        atomic_write_bytes(os.path.join(tag_dir, "data_sampler_admitted.npy"), admitted_bytes,
                           op="sampler_sidecar", policy=policy)
        files["data_sampler_admitted.npy"] = admitted_bytes
    atomic_write_bytes(os.path.join(tag_dir, "client_state.json"), meta_bytes,
                       op="client_state", policy=policy)
    write_manifest(tag_dir, tag, files, policy=policy, advance_latest=True)
    return payload[0]
