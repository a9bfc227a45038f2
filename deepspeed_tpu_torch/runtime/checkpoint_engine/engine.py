"""Checkpoint save and verified load for the training engine.

Counterpart of ``deepspeed_tpu/runtime/checkpoint_engine/engine.py``, with
``torch.save`` in place of orbax and the same tag layout:

    <save_dir>/<tag>/state/<field>.pt      one file per top-level field
    <save_dir>/<tag>/state/_CHECKPOINT_METADATA   the commit marker
    <save_dir>/<tag>/client_state.json     counters, schedules, data position
    <save_dir>/<tag>/data_sampler_admitted.npy    with a curriculum sampler
    <save_dir>/<tag>/manifest.json         sha256 and sizes (resilience)
    <save_dir>/latest                      the newest tag, written last

The state is flat, under the keys of the JAX module's ``_flatten_state``:
``step``, ``params/<name>``, ``master/<name>``, ``opt_state/<field>[/<name>]``,
``scaler/<field>`` and ``skipped_steps``, with ``<name>`` the module's
parameter name. Each top-level field is one file, so ``load_module_only``
reads only ``params.pt``. The files are written into a temp directory in the
tag, each fsynced, the commit marker last, and the directory is then renamed
to ``state``; the sidecars, the manifest and ``latest`` follow in that order,
so a crash leaves the previous tag intact or this one verifiable.

With ``checkpoint.async_save`` (the default) ``save_checkpoint`` blocks only
for the copy of the state to host memory; a daemon thread writes the rest.
Loads, the next save and the exit wait for it. Load verifies each candidate
tag's manifest and falls back to the newest good one. The rewind tiers,
emergency tags, the chaos injector and elastic resizes are later slices.

State under ZeRO-Offload is read and written where it lives (the card,
host memory, the NVMe optimizer's files), one unit at a time; a tag does not
record where the state lived, so a tag saved with offload loads without it
and the other way round.

Over many processes a tag stays world-agnostic, as the JAX orbax tag is:
every rank takes part in gathering the whole tensors from the ZeRO
partitions, one unit of one tensor list at a time (before
``save_checkpoint`` returns, async or not); rank 0 copies each unit to the
host before the next is gathered, the other ranks keep nothing, and rank 0
alone writes, after a barrier, the files a world of one writes at any
stage, without padding. The tag is rank 0's
(``checkpoint.tag_validation`` warns or fails when the ranks asked for
different ones). A load waits for rank 0's pending commit behind a
barrier; each rank reads the whole tensors on the host and moves its
partition to the card a unit at a time, at any world size and stage, and
all ranks must pick the same candidate tag.
"""

from __future__ import annotations

import atexit
import io
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.resilience.fsio import (atomic_write_bytes, atomic_write_text,
                                                 fsync_dir)
from deepspeed_tpu_torch.resilience.manifest import (COMMIT_MARKER, MANIFEST_NAME,
                                                     SAMPLER_SIDECAR, STATE_DIR,
                                                     candidate_tags, verify_tag,
                                                     write_manifest)
from deepspeed_tpu_torch.resilience.retry import NO_RETRY, RetryPolicy, retry
from deepspeed_tpu_torch.runtime.zero.state import PARAMS
from deepspeed_tpu_torch.utils.logging import log_dist, logger

# the top-level fields of the flat state, one file each
STATE_FIELDS = ("step", "params", "master", "opt_state", "scaler", "skipped_steps")


def _ckpt_dir(save_dir: str, tag: str) -> str:
    return os.path.join(os.path.abspath(save_dir), str(tag))


class CheckpointLayoutError(ValueError):
    """A checkpoint's recorded head layout differs from the live model's.
    Param shapes do not depend on the head count, so such a checkpoint
    would load silently and compute something else. Never demoted to an
    older candidate: every tag of one run shares the layout."""


# a tier-1 emergency snapshot's payload (the rewind block's); the port
# restores none, so load skips such tags with a warning
REWIND_STATE_FILE = os.path.join("state", "rewind_state.npz")


def is_emergency_tag(tag_dir: str) -> bool:
    return os.path.isfile(os.path.join(tag_dir, REWIND_STATE_FILE))


def world_signature(engine) -> dict:
    """The placement world a state was saved under, in the JAX package's
    fields. The port's world is data parallel only: its mesh is one
    ``data`` axis."""
    dev = getattr(engine, "device", None)
    count = torch.cuda.device_count() if dev is not None and dev.type == "cuda" else 1
    return {"dp_world_size": int(engine.dp_world_size), "device_count": int(count),
            "mesh_shape": [("data", int(engine.dp_world_size))]}


# model-config facts recorded with a checkpoint and checked on load: the
# head grouping is what would load silently; the sizes make the error clear
_LAYOUT_FIELDS = ("n_head", "n_kv_head", "num_attention_heads", "num_key_value_heads",
                  "head_dim", "n_embd", "hidden_size", "n_layer")


def model_layout(engine) -> Optional[dict]:
    cfg = getattr(getattr(engine, "module", None), "config", None)
    if cfg is None:
        return None
    out = {}
    for f in _LAYOUT_FIELDS:
        v = getattr(cfg, f, None)
        if isinstance(v, int) and not isinstance(v, bool):
            out[f] = v
    return out or None


def check_model_layout(engine, meta: dict, source: str) -> None:
    """Raise :class:`CheckpointLayoutError` naming both layouts when the
    checkpoint's recorded layout and the live model's differ on a shared
    field. A checkpoint without the record passes."""
    saved = (meta or {}).get("model_layout")
    live = model_layout(engine)
    if not saved or not live:
        return
    diff = {f: (saved[f], live[f]) for f in saved if f in live and saved[f] != live[f]}
    if diff:
        raise CheckpointLayoutError(
            f"checkpoint {source} was saved under a different model layout: "
            + "; ".join(f"{f} was {a} at save but is {b} now"
                        for f, (a, b) in sorted(diff.items()))
            + f" (saved layout {saved} vs live {live}). Param shapes are head-count "
            "invariant, so loading would silently reinterpret the attention grouping "
            "— refuse instead. Load with a model config matching the checkpoint, or "
            "re-export the weights under the new layout.")


def _retry_policy(engine) -> RetryPolicy:
    res = getattr(getattr(engine, "_config", None), "resilience", None)
    if res is None:
        return RetryPolicy()
    r = res.retry
    if not r.enabled:
        return NO_RETRY
    return RetryPolicy(max_attempts=r.max_attempts, base_delay=r.base_delay,
                       multiplier=r.multiplier, max_delay=r.max_delay,
                       deadline=r.deadline, jitter=r.jitter)


# ----------------------------------------------------------- the flat state
def _state_spec(engine):
    """Every key of the flat state, once, in order: ``(key, whole shape,
    source)``, the source ``(tensors, i)`` for parameter ``i`` of a
    ZeRO-laid-out source (``to_host``'s), else a function that gives the
    value."""
    z, plan = engine._zero, engine._plan
    index = {p.name: i for i, p in enumerate(plan.params)}
    spec = [("step", (), lambda: torch.tensor(engine._global_step, dtype=torch.int64))]
    for name, p in engine.module.named_parameters():
        if name in index:
            spec.append((f"params/{name}", plan.params[index[name]].shape,
                         (PARAMS, index[name])))
        else:
            spec.append((f"params/{name}", tuple(p.shape), lambda p=p: p.detach()))
    if engine._keep_master:
        spec += [(f"master/{p.name}", p.shape, (z.fp32, i)) for i, p in enumerate(plan.params)]
    for field, v in engine.opt_state.state_dict().items():
        if _per_unit(v):
            spec += [(f"opt_state/{field}/{p.name}", p.shape, (v, i))
                     for i, p in enumerate(plan.params)]
        elif v is not None:
            spec.append((f"opt_state/{field}", (),
                         lambda v=v: torch.tensor(v, dtype=torch.int64)))
    if engine.scaler_state is not None:
        for field, v in engine.scaler_state.state_dict().items():
            spec.append((f"scaler/{field}", (), lambda v=v: torch.tensor(
                v, dtype=torch.float64 if isinstance(v, float) else torch.int64)))
    spec.append(("skipped_steps", (),
                 lambda: torch.tensor(engine._skipped_steps, dtype=torch.int64)))
    return spec


def _per_unit(v) -> bool:
    """An optimizer-state field laid out as ZeroState.fp32: a list of
    tensors, or the NVMe files' per-unit view (``SwapUnits``)."""
    return isinstance(v, list) or hasattr(v, "write_unit")


def flatten_state(engine, keep: bool = True) -> Dict[str, torch.Tensor]:
    """The engine's training state under flat keys, as whole tensors on the
    host, each its own storage (a copy from the card waits for it, so the
    next step cannot change what is saved). Every rank must call it: under
    ZeRO stages 1-3 it gathers the partitions, one unit of one source at a
    time, so the card holds one gathered unit at most beyond the state.
    ``keep=False`` (a rank that does not write) takes part in the gathers
    and keeps nothing. An engine with a layout of its own (ZeRO-Infinity's)
    gives the same keys through its ``flat_state``."""
    if hasattr(engine, "flat_state"):
        return engine.flat_state() if keep else {}
    spec = _state_spec(engine)
    sources = {}                        # id(source) -> (source, {param index: key})
    for key, _, get in spec:
        if isinstance(get, tuple):
            sources.setdefault(id(get[0]), (get[0], {}))[1][get[1]] = key
    whole = {}
    for source, keys in sources.values():
        for i, t in enumerate(engine._zero.to_host(source, keep)):
            if i in keys:
                whole[keys[i]] = t
    if not keep:
        return {}
    return {key: whole[key] if isinstance(get, tuple)
            else get().to("cpu", copy=True).contiguous() for key, _, get in spec}


def state_shapes(engine) -> Dict[str, tuple]:
    """The keys of :func:`flatten_state` and their whole shapes, without a
    collective."""
    if hasattr(engine, "flat_state_shapes"):
        return engine.flat_state_shapes()
    return {key: tuple(shape) for key, shape, _ in _state_spec(engine)}


def _field(key: str) -> str:
    return key.split("/", 1)[0]


def _fsync_file(path: str) -> None:
    with open(path, "rb+") as f:
        os.fsync(f.fileno())


def _write_state(tag_dir: str, host: Mapping[str, torch.Tensor]) -> int:
    """Write ``<tag_dir>/state``: one ``torch.save`` file per field into a
    temp directory beside it, each fsynced, the commit marker last, then the
    rename. Returns the bytes written."""
    os.makedirs(tag_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=STATE_DIR + ".tmp.", dir=tag_dir)
    try:
        files = []
        for field in STATE_FIELDS:
            part = {k: v for k, v in host.items() if _field(k) == field}
            if not part:
                continue
            path = os.path.join(tmp, f"{field}.pt")
            torch.save(part, path)
            _fsync_file(path)
            files.append(f"{field}.pt")
        marker = os.path.join(tmp, os.path.basename(COMMIT_MARKER))
        with open(marker, "w") as f:
            json.dump({"format": "torch.save", "files": files}, f)
            f.flush()
            os.fsync(f.fileno())
        fsync_dir(tmp)
        final = os.path.join(tag_dir, STATE_DIR)
        if os.path.isdir(final):          # overwriting a tag
            shutil.rmtree(final)
        os.replace(tmp, final)
        fsync_dir(tag_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return sum(os.path.getsize(os.path.join(final, n)) for n in files)


def read_state(tag_dir: str, fields, device) -> Dict[str, torch.Tensor]:
    """The flat state of the given fields from a committed tag, on
    ``device``; a field the tag lacks is absent."""
    flat = {}
    for field in fields:
        path = os.path.join(tag_dir, STATE_DIR, f"{field}.pt")
        if os.path.isfile(path):
            flat.update(torch.load(path, map_location=device, weights_only=True))
    return flat


# ------------------------------------------------------ pending async saves
_pending_threads: list = []
_pending_lock = threading.Lock()


def wait_for_pending_saves() -> None:
    """Block until every background checkpoint write has finished (its
    ``latest`` advanced, or its failure logged). A thread stays listed
    until it has finished, so a wait running beside another one still
    joins it; a commit thread never waits on itself."""
    me = threading.current_thread()
    while True:
        with _pending_lock:
            _pending_threads[:] = [t for t in _pending_threads if t.is_alive()]
            pending = [t for t in _pending_threads if t is not me]
        if not pending:
            return
        for t in pending:
            t.join()


# a trainer that exits right after save_checkpoint must not lose the save
atexit.register(wait_for_pending_saves)


def capture_host_meta(engine) -> dict:
    """The host-side progress facts client_state.json records, taken now,
    with the state they describe."""
    sampler = getattr(engine, "_data_sampler", None)
    loader = getattr(engine, "dataloader", None)
    return {
        "global_samples": engine.global_samples,
        "micro_steps": engine.micro_steps,
        "lr_scheduler": (engine.lr_scheduler.state_dict()
                         if engine.lr_scheduler is not None else None),
        "data_sampler": sampler.state_dict() if sampler is not None else None,
        "data_loader": (loader.state_dict()
                        if loader is not None and hasattr(loader, "state_dict") else None),
    }


def agreed_tag(engine, tag: str) -> str:
    """Rank 0's tag, on every rank. Under ``checkpoint.tag_validation``
    Warn (Fail) a rank that asked for another tag logs (raises)."""
    if comm.get_world_size() == 1:
        return tag
    tags = [str(t) for t in comm.allgather_host(np.array(str(tag)))]
    cfg = engine._config
    if len(set(tags)) > 1 and cfg.checkpoint_tag_validation_enabled:
        msg = f"checkpoint tags differ across ranks: {tags}; rank 0's {tags[0]!r} is used"
        if cfg.checkpoint_tag_validation_fail:
            raise ValueError(msg)
        logger.warning(msg)
    return tags[0]


def save_engine_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                           client_state: Optional[dict] = None,
                           save_latest: bool = True) -> bool:
    """Save the engine's state as tag ``tag`` (default ``global_step<N>``).
    ``engine._last_save`` records the tag, the state's bytes, the seconds
    the call blocked and, once the commit is done, the seconds to write the
    state (``write_s``) and to commit the whole tag (``commit_s``, from the
    call to ``latest``), or the error."""
    t0 = time.perf_counter()
    tag = agreed_tag(engine, tag or f"global_step{engine.global_steps}")
    path = _ckpt_dir(save_dir, tag)
    policy = _retry_policy(engine)
    writer = comm.get_rank() == 0

    # one save in flight at a time; and an overwritten tag's old manifest
    # would fail the new files, so it goes first (until the new one lands,
    # the tag falls back to the marker-and-client-state acceptance)
    wait_for_pending_saves()
    if not writer:
        flatten_state(engine, keep=False)   # this rank's part of the gathers
        comm.barrier()
        engine._last_save = {"tag": tag, "path": path, "bytes": 0, "writer": False,
                             "blocking_s": time.perf_counter() - t0}
        return True
    stale_manifest = os.path.join(path, MANIFEST_NAME)
    if os.path.exists(stale_manifest):
        def drop_stale():
            try:
                os.remove(stale_manifest)
            except FileNotFoundError:
                pass
        retry(drop_stale, policy, op="manifest")

    host = flatten_state(engine)
    comm.barrier()                          # every rank's gathers are done
    host_meta = capture_host_meta(engine)
    manifest_files = {}
    sampler_sd = host_meta["data_sampler"]
    if sampler_sd is not None and isinstance(sampler_sd.get("admitted"), np.ndarray):
        buf = io.BytesIO()
        np.save(buf, sampler_sd.pop("admitted"))
        manifest_files[SAMPLER_SIDECAR] = buf.getvalue()
        sampler_sd["admitted_file"] = SAMPLER_SIDECAR
    meta = {
        "tag": tag,
        "global_steps": int(engine.global_steps),
        "skipped_steps": int(engine.skipped_steps),
        "global_samples": host_meta["global_samples"],
        "micro_steps": host_meta["micro_steps"],
        "lr_scheduler": host_meta["lr_scheduler"],
        "client_state": client_state or {},
        "zero_stage": engine.zero_stage,
        "dp_world_size": engine.dp_world_size,
        "world": world_signature(engine),
        "model_layout": model_layout(engine),
        "data_sampler": sampler_sd,
        "data_loader": host_meta["data_loader"],
    }
    manifest_files["client_state.json"] = json.dumps(meta, default=str).encode("utf-8")
    record = {"tag": tag, "path": path, "writer": True,
              "bytes": sum(v.numel() * v.element_size() for v in host.values())}

    def commit():
        t_write = time.perf_counter()
        retry(lambda: _write_state(path, host), policy, op="state_save")
        record["write_s"] = time.perf_counter() - t_write
        # the state has committed; then the sidecars, the manifest that
        # indexes them, and the pointer last
        if SAMPLER_SIDECAR in manifest_files:
            atomic_write_bytes(os.path.join(path, SAMPLER_SIDECAR),
                               manifest_files[SAMPLER_SIDECAR], op="sampler_sidecar",
                               policy=policy)
        atomic_write_bytes(os.path.join(path, "client_state.json"),
                           manifest_files["client_state.json"], op="client_state",
                           policy=policy)
        write_manifest(path, tag, manifest_files, policy=policy, advance_latest=save_latest)
        if save_latest:
            atomic_write_text(os.path.join(os.path.abspath(save_dir), "latest"), tag,
                              op="latest", policy=policy)
        record["commit_s"] = time.perf_counter() - t0

    if engine._config.checkpoint_config.async_save:
        def background():
            try:
                commit()
            except Exception as e:      # a daemon thread: log it, never die silent
                record["error"] = repr(e)
                logger.error(f"async checkpoint {tag}: commit failed ({e!r}); 'latest' "
                             "was not advanced and the tag may not verify")

        t = threading.Thread(target=background, name=f"ds-ckpt-commit-{tag}", daemon=True)
        with _pending_lock:         # no wait may see it before it runs
            t.start()
            _pending_threads.append(t)
    else:
        commit()
    record["blocking_s"] = time.perf_counter() - t0
    engine._last_save = record
    log_dist(f"saved checkpoint {tag} to {save_dir}", ranks=[0])
    return True


# ---------------------------------------------------------------- restore
def _check_restored(engine, flat: Mapping[str, torch.Tensor], fields) -> None:
    """Every key the engine's state has in ``fields`` is in ``flat`` with
    the live shape (a scaler saved by another recipe may be absent)."""
    live = state_shapes(engine)
    want = {k for k in live if _field(k) in fields and _field(k) != "scaler"}
    missing = sorted(want - set(flat))
    if missing:
        raise KeyError(f"checkpoint state lacks {len(missing)} key(s), e.g. {missing[:3]}")
    for k in want:
        if tuple(flat[k].shape) != tuple(live[k]):
            raise ValueError(f"checkpoint {k} has shape {tuple(flat[k].shape)}, the "
                             f"engine's is {tuple(live[k])}")


@torch.no_grad()
def apply_flat_state(engine, flat: Mapping[str, torch.Tensor], load_module_only: bool = False,
                     load_optimizer_states: bool = True) -> None:
    """Copy a flat state of whole tensors into the engine's tensors in
    place; under ZeRO stages 1-3 each rank keeps its partition.

    ``load_optimizer_states=False`` takes the params and the masters only;
    the optimizer state, the loss scale and the step counters stay the
    engine's, as in the JAX package. ``load_module_only`` takes the params
    only and refreshes the fp32 masters from them (the reference's
    ``refresh_fp32_params``), so the next step updates the loaded weights;
    the JAX package keeps its live masters there."""
    if hasattr(engine, "apply_flat_state"):
        engine.apply_flat_state(flat, load_module_only, load_optimizer_states)
        return
    names = engine._param_names
    trained = set(names)
    for name, p in engine.module.named_parameters():
        if name not in trained:
            p.copy_(flat[f"params/{name}"])
    params = [flat[f"params/{n}"] for n in names]
    masters = params if load_module_only or not engine._keep_master \
        else [flat[f"master/{n}"] for n in names]
    z = engine._zero
    z.load(PARAMS, params)
    z.load(z.fp32, masters)
    if load_module_only or not load_optimizer_states:
        return
    sd = {}
    for field, v in engine.opt_state.state_dict().items():
        if _per_unit(v):
            z.load(v, [flat[f"opt_state/{field}/{n}"] for n in names])   # in place
            sd[field] = v
        elif v is None:
            sd[field] = None
        else:
            sd[field] = int(flat[f"opt_state/{field}"])
    engine.opt_state = engine.opt_state.load_state_dict(sd)
    if engine.scaler_state is not None and "scaler/scale" in flat:
        engine.scaler_state = engine.scaler_state.load_state_dict(
            {k[len("scaler/"):]: v.item() for k, v in flat.items() if _field(k) == "scaler"})
    engine._global_step = int(flat["step"])
    engine._skipped_steps = int(flat["skipped_steps"])
    if getattr(engine, "_nvme_optimizer", None) is not None:
        engine._nvme_optimizer.step_count = engine.opt_state.count


def apply_restored_meta(engine, meta: dict) -> None:
    """Apply a restored tag's host-side facts to the live engine: sample and
    micro-step counters, the LR schedule, the curriculum sampler, the data
    loader's position, and the seqlen curriculum's difficulty at the
    restored step."""
    if meta:
        engine.global_samples = meta.get("global_samples", 0) or 0
        engine.micro_steps = meta.get("micro_steps", 0) or 0
        if engine.lr_scheduler is not None and meta.get("lr_scheduler"):
            engine.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        sampler_sd = meta.get("data_sampler")
        if sampler_sd:
            if getattr(engine, "_data_sampler", None) is not None:
                engine._data_sampler.load_state_dict(sampler_sd)
            else:
                # no loader yet: deepspeed_io applies it when it builds one
                engine._pending_sampler_state = sampler_sd
        loader_sd = meta.get("data_loader")
        if loader_sd:
            loader = getattr(engine, "dataloader", None)
            if loader is not None and hasattr(loader, "load_state_dict"):
                try:
                    loader.load_state_dict(loader_sd)
                except ValueError as e:
                    logger.warning(f"dataloader position NOT restored ({e}); the loader "
                                   "starts from its beginning")
            else:
                logger.warning(
                    "checkpoint carries a dataloader position but this engine has no "
                    "loader to apply it to (pass training_data= or set engine.dataloader "
                    "before load_checkpoint for exactly-once sample accounting)")
    sched = getattr(engine, "curriculum_scheduler", None)
    if sched is not None and sched.schedule_type != "custom":
        # a custom schedule needs its function installed first; train_batch
        # recomputes the difficulty on the next step anyway
        sched.update_difficulty(engine.global_steps + 1)


def load_engine_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                           load_optimizer_states: bool = True, load_module_only: bool = False):
    """Verified restore with fallback to the last good tag. Returns (tag
    path, client_state), or (None, {}) when nothing was restored.

    Candidates come newest first (``candidate_tags``; ``latest`` is a hint
    that a provably newer committed tag outranks). Each must pass its
    manifest (``resilience.verify_on_load``) and then read back whole;
    otherwise the next is tried (``resilience.fallback_to_last_good``). An
    explicit ``tag`` is a contract: no fallback. ``engine._last_recovery``
    records the tier, the step and the seconds the restore took."""
    wait_for_pending_saves()
    comm.barrier()                          # rank 0's commit has landed
    engine._last_recovery = None
    res = engine._config.resilience
    candidates = candidate_tags(load_dir, preferred=tag)
    if tag is not None:
        if tag not in candidates:
            logger.warning(f"checkpoint {_ckpt_dir(load_dir, tag)} not found")
            return None, {}
        candidates = [tag]
    if not candidates:
        logger.warning(f"no checkpoint tags in {load_dir}; nothing loaded")
        return None, {}
    if not res.fallback_to_last_good:
        candidates = candidates[:1]

    fields = ("params",) if load_module_only else \
        ("params", "master") if not load_optimizer_states else STATE_FIELDS
    skipped = []
    t_restore = time.perf_counter()
    for cand in candidates:
        path = _ckpt_dir(load_dir, cand)
        if res.verify_on_load:
            ok, reason = verify_tag(path)
            if not ok:
                logger.warning(f"skipping checkpoint {cand!r}: {reason}")
                skipped.append(cand)
                continue
        if is_emergency_tag(path):
            logger.warning(f"skipping emergency snapshot tag {cand!r}: the 'rewind' "
                           "ds_config block is absent (enable it to restore preemption "
                           "emergency saves)")
            skipped.append(cand)
            continue
        try:
            if not os.path.isfile(os.path.join(path, COMMIT_MARKER)):
                raise FileNotFoundError("no committed state/")
            flat = read_state(path, fields, "cpu")
            _check_restored(engine, flat, fields)
            meta = {}
            meta_path = os.path.join(path, "client_state.json")
            if os.path.isfile(meta_path):
                with open(meta_path) as f:
                    meta = json.load(f)
            sampler_sd = meta.get("data_sampler")
            if sampler_sd and sampler_sd.get("admitted_file"):
                sampler_sd["admitted"] = np.load(
                    os.path.join(path, sampler_sd.pop("admitted_file")))
        except Exception as e:
            # a torn file, unparseable metadata, a state of another shape:
            # every restore-side failure demotes to the next candidate
            logger.warning(f"skipping checkpoint {cand!r}: restore failed ({e!r})")
            skipped.append(cand)
            continue
        break
    else:
        cand = None
    chosen = comm.broadcast_object_list([cand])[0]
    if chosen != cand:
        raise RuntimeError(f"rank {comm.get_rank()} would restore {cand!r} from {load_dir}, "
                           f"rank 0 {chosen!r}: the ranks see different checkpoints")
    if cand is None:
        logger.warning(f"no restorable checkpoint in {load_dir} (tried {candidates}); "
                       "nothing loaded")
        return None, {}

    # outside the demotion loop: every candidate of a run shares the layout
    check_model_layout(engine, meta, source=os.path.basename(str(cand)))
    apply_flat_state(engine, flat, load_module_only=load_module_only,
                     load_optimizer_states=load_optimizer_states)
    del flat
    apply_restored_meta(engine, meta)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    engine._last_recovery = {"tier": "disk", "snapshot_step": int(engine.global_steps),
                             "steps_lost": None,
                             "restore_s": round(time.perf_counter() - t_restore, 4)}
    if skipped:
        log_dist(f"checkpoint fallback: restored {cand!r} after skipping {skipped} "
                 "(corrupt/unverified)", ranks=[0])
    log_dist(f"loaded checkpoint {cand} from {load_dir}", ranks=[0])
    return path, meta.get("client_state", {})


# ------------------------------------------------------- JAX tags carried
def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes, which torch cannot take
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def state_from_jax(flat_numpy: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A JAX tag's flat state (its ``state/`` tree restored to numpy leaves,
    under ``_flatten_state`` keys) in the port's flat layout, for
    :func:`apply_flat_state`. Layer-stacked leaves (``.../blocks/<key>``, L
    first) become one entry per layer (``.../blocks.<n>.<key>``), as
    ``models.gpt2.params_from_jax`` maps the params; the other keys keep
    their names with ``.`` for ``/``. The JAX engine's ``rng`` has no
    counterpart and is dropped. The copy is exact."""
    out = {}
    for key, leaf in flat_numpy.items():
        if leaf is None or key == "rng":
            continue
        if key in ("step", "skipped_steps", "opt_state/count"):
            out[key] = torch.tensor(int(np.asarray(leaf)), dtype=torch.int64)
            continue
        if key.startswith("scaler/"):
            v = np.asarray(leaf)
            out[key] = torch.tensor(v.item(), dtype=torch.float64 if v.dtype.kind == "f"
                                    else torch.int64)
            continue
        prefix, _, rest = key.partition("/")
        if prefix == "opt_state":
            moment, _, rest = rest.partition("/")
            prefix = f"opt_state/{moment}"
        if rest.startswith("blocks/"):
            sub = rest[len("blocks/"):].replace("/", ".")
            stacked = np.asarray(leaf)
            for n in range(stacked.shape[0]):
                out[f"{prefix}/blocks.{n}.{sub}"] = _to_torch(stacked[n])
        else:
            out[f"{prefix}/{rest.replace('/', '.')}"] = _to_torch(leaf)
    return out
