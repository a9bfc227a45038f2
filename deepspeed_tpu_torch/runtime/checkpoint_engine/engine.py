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
parameter name, except that a model's ``stacked_modules`` (MoE GPT-2's
``moe``) are held stacked over their layers as the JAX tree holds them:
``moe.experts.wi`` (n_moe, E, D, H) for ``moe.<p>.experts.wi`` (the whole
E experts, gathered over the expert-parallel group at a save and sliced
again at a load, so a tag of one expert-parallel size loads at another).
Each top-level field is one file, so ``load_module_only``
reads only ``params.pt``. The files are written into a temp directory in the
tag, each fsynced, the commit marker last, and the directory is then renamed
to ``state``; the sidecars, the manifest and ``latest`` follow in that order,
so a crash leaves the previous tag intact or this one verifiable.

With ``checkpoint.async_save`` (the default) ``save_checkpoint`` blocks only
for the copy of the state to host memory; a daemon thread writes the rest.
Loads, the next save and the exit wait for it. Every file write passes the
chaos injector's hooks (``state_save`` inside the retried state write, the
sidecars', the manifest's and ``latest``'s in ``resilience/fsio.py``).

Load is the rewind ladder's walk, as in JAX: the freshest verified tier
wins. With the ``rewind`` block, the host-RAM snapshot ring first, when its
newest usable snapshot is at least as new as the best disk candidate; then
the disk candidates newest first, each verified against its manifest:
``emergency_step<N>`` tags (``state/rewind_state.npz``, restored from
their payload by the rewind manager) and ordinary tags; when every disk
candidate fails, the ring once more without the freshness gate. Without the
block an emergency tag is skipped loudly. A snapshot taken on another world
degrades loudly to the disk tier (JAX's behaviour without
``elasticity.resize``). Every restore stamps ``engine._last_recovery =
{tier, snapshot_step, steps_lost, restore_s}``.

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
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.resilience import chaos as _chaos
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


# a tier-1 emergency snapshot's payload; defined here, not in
# resilience/rewind.py, so the ladder classifies tags without importing
# the rewind module (which stays unloaded without its block)
REWIND_STATE_FILE = os.path.join("state", "rewind_state.npz")


def is_emergency_tag(tag_dir: str) -> bool:
    """Does this tag hold an emergency snapshot (an npz payload) rather
    than the ``torch.save`` state files?"""
    return os.path.isfile(os.path.join(tag_dir, REWIND_STATE_FILE))


def world_signature(engine) -> dict:
    """The placement world a state was saved under, in the JAX package's
    fields: the ``data`` axis, and ``expert`` inside it when above 1."""
    dev = getattr(engine, "device", None)
    count = torch.cuda.device_count() if dev is not None and dev.type == "cuda" else 1
    ep = int(getattr(engine, "ep_world_size", 1))
    mesh = [("data", int(engine.dp_world_size) // ep)] + ([("expert", ep)] if ep > 1 else [])
    return {"dp_world_size": int(engine.dp_world_size), "device_count": int(count),
            "mesh_shape": mesh}


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
def _layer_key(key: str, prefixes):
    """``'params/moe.3.experts.wi'`` → (``'params/moe.experts.wi'``, 3) for a
    stacked module list ``moe`` among ``prefixes``; None for another key."""
    head, _, name = key.rpartition("/")
    parts = name.split(".", 2)
    if len(parts) == 3 and parts[0] in prefixes and parts[1].isdigit():
        return f"{head}/{parts[0]}.{parts[2]}", int(parts[1])
    return None


def stack_layers(flat: Mapping, module) -> dict:
    """``flat`` with the per-layer keys of ``module``'s ``stacked_modules``
    stacked over their layers (in layer order, at the first layer's place);
    the other keys as they are. Values may be tensors or shapes."""
    prefixes = tuple(getattr(module, "stacked_modules", ()))
    if not prefixes:
        return dict(flat)
    layers: Dict[str, dict] = {}
    out = {}
    for key, v in flat.items():
        hit = _layer_key(key, prefixes)
        if hit is None:
            out[key] = v
            continue
        if hit[0] not in layers:
            out[hit[0]] = None
            layers[hit[0]] = {}
        layers[hit[0]][hit[1]] = v
    for key, by_layer in layers.items():
        vals = [by_layer[n] for n in range(len(by_layer))]
        out[key] = torch.stack(vals) if torch.is_tensor(vals[0]) \
            else (len(vals),) + tuple(vals[0])
    return out


def unstack_layers(flat: Mapping, module) -> dict:
    """The inverse of :func:`stack_layers`: a stacked key of ``module``'s
    ``stacked_modules`` becomes one key per layer."""
    prefixes = tuple(getattr(module, "stacked_modules", ()))
    out = {}
    for key, v in flat.items():
        head, _, name = key.rpartition("/")
        first, _, rest = name.partition(".")
        if first in prefixes and rest and not rest.split(".")[0].isdigit():
            for n in range(v.shape[0]):
                out[f"{head}/{first}.{n}.{rest}"] = v[n]
        else:
            out[key] = v
    return out


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
            spec.append((f"params/{name}", z.whole_shape(index[name]), (PARAMS, index[name])))
        else:
            spec.append((f"params/{name}", tuple(p.shape), lambda p=p: p.detach()))
    if engine._keep_master:
        spec += [(f"master/{p.name}", z.whole_shape(i), (z.fp32, i))
                 for i, p in enumerate(plan.params)]
    for field, v in engine.opt_state.state_dict().items():
        if _per_unit(v):
            spec += [(f"opt_state/{field}/{p.name}", z.whole_shape(i), (v, i))
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
    return stack_layers({key: whole[key] if isinstance(get, tuple)
                         else get().to("cpu", copy=True).contiguous() for key, _, get in spec},
                        engine.module)


def state_shapes(engine) -> Dict[str, tuple]:
    """The keys of :func:`flatten_state` and their whole shapes, without a
    collective."""
    if hasattr(engine, "flat_state_shapes"):
        return engine.flat_state_shapes()
    return stack_layers({key: tuple(shape) for key, shape, _ in _state_spec(engine)},
                        engine.module)


def host_state_layout(engine) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Every key of the flat state, per parameter (a model's
    ``stacked_modules`` not stacked), with its whole shape and dtype: what
    :func:`copy_state_into` fills."""
    plan = engine._plan
    out = {}
    for key, shape, get in _state_spec(engine):
        if isinstance(get, tuple):
            source, i = get
            dtype = engine._params[i].dtype if isinstance(source, str) \
                else source[plan.params[i].unit].dtype
        else:
            dtype = get().dtype
        out[key] = (tuple(shape), dtype)
    return out


@torch.no_grad()
def copy_state_into(engine, slot: Mapping[str, torch.Tensor]) -> None:
    """The engine's whole state, under :func:`host_state_layout`'s keys,
    copied into the host tensors of ``slot`` (pinned ones from the card
    asynchronously, then one wait): a snapshot without allocating. Every
    rank calls it (the ZeRO gathers), and every rank keeps the whole."""
    sources = {}                        # id(source) -> (source, {param index: key})
    for key, _, get in _state_spec(engine):
        if isinstance(get, tuple):
            sources.setdefault(id(get[0]), (get[0], {}))[1][get[1]] = key
        else:
            slot[key].copy_(get())
    for source, keys in sources.values():
        engine._zero.to_host(source, into=[slot[keys[i]] for i in range(len(keys))])
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


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

    def write_state():
        inj = _chaos.active_injector()
        if inj is not None:
            inj.before("state_save", path)
        _write_state(path, host)

    def commit():
        t_write = time.perf_counter()
        retry(write_state, policy, op="state_save")
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
    engine._zero.reset_grads()          # a restore after a step that did not finish
    flat = unstack_layers(flat, engine.module)
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
    pld = getattr(engine, "progressive_layer_drop", None)
    if pld is not None:
        pld.update_state(engine.global_steps)


def _best_restorable_step(load_dir: str, candidates, verify: bool, cache: dict) -> int:
    """The step of the newest disk candidate that verifies, -1 when none:
    what the RAM tier must match to win. An unverified candidate's step
    would let a corrupt newest tag evict a fresher RAM snapshot in favour
    of an older disk tag. The verdicts land in ``cache``."""
    from deepspeed_tpu_torch.resilience.manifest import tag_step

    for cand in candidates:
        if verify:
            verdict = verify_tag(_ckpt_dir(load_dir, cand))
            cache[cand] = verdict
            if not verdict[0]:
                continue
        return tag_step(cand)           # an unparsable step (-1): RAM wins
    return -1


def load_engine_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                           load_optimizer_states: bool = True, load_module_only: bool = False):
    """Verified restore with fallback to the last good tag: the rewind
    ladder's walk (module docstring). Returns (tag path, client_state);
    ``("ram://step<N>", {})`` from the RAM tier; (None, {}) when nothing
    was restored.

    Disk candidates come newest first (``candidate_tags``; ``latest`` is a
    hint that a provably newer committed tag outranks, as an emergency tag
    is). Each must pass its manifest (``resilience.verify_on_load``) and
    then read back whole; otherwise the next is tried
    (``resilience.fallback_to_last_good``). An explicit ``tag`` is a
    contract: no other tier, no fallback. A partial load
    (``load_module_only``, no optimizer states) never takes the RAM tier."""
    wait_for_pending_saves()
    comm.barrier()                          # rank 0's commit has landed
    engine._last_recovery = None
    res = engine._config.resilience
    rewind_mgr = getattr(engine, "_rewind", None)
    whole = tag is None and not load_module_only and load_optimizer_states
    candidates = candidate_tags(load_dir, preferred=tag)

    verified: dict = {}
    if rewind_mgr is not None and whole:
        info = rewind_mgr.restore_from_ram(
            min_step=_best_restorable_step(load_dir, candidates, res.verify_on_load, verified),
            for_dir=load_dir)
        if info is not None:
            return f"ram://step{info['snapshot_step']}", {}
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
    tier = "disk"
    t_restore = time.perf_counter()
    for cand in candidates:
        path = _ckpt_dir(load_dir, cand)
        if res.verify_on_load:
            ok, reason = verified[cand] if cand in verified else verify_tag(path)
            if not ok:
                logger.warning(f"skipping checkpoint {cand!r}: {reason}")
                skipped.append(cand)
                continue
        emergency = is_emergency_tag(path)
        if emergency and rewind_mgr is None:
            logger.warning(f"skipping emergency snapshot tag {cand!r}: the 'rewind' "
                           "ds_config block is absent (enable it to restore preemption "
                           "emergency saves)")
            skipped.append(cand)
            continue
        try:
            if emergency:
                flat, meta = rewind_mgr.load_emergency_tag(path, verified=res.verify_on_load)
                if flat is None:            # another world: warned inside
                    skipped.append(cand)
                    continue
                tier = "emergency"
            else:
                if not os.path.isfile(os.path.join(path, COMMIT_MARKER)):
                    raise FileNotFoundError("no committed state/")
                flat = read_state(path, fields, "cpu")
                _check_restored(engine, flat, fields)
                meta = {}
                meta_path = os.path.join(path, "client_state.json")
                if os.path.isfile(meta_path):
                    with open(meta_path) as f:
                        meta = json.load(f)
                tier = "disk"
            # the curriculum sampler's admitted order rides a sidecar on both tiers
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
        if rewind_mgr is not None and whole:
            # every disk tier failed: a RAM snapshot older than the best
            # unrestorable disk step beats nothing
            info = rewind_mgr.restore_from_ram(for_dir=load_dir)
            if info is not None:
                logger.warning(f"no restorable disk checkpoint in {load_dir} (tried "
                               f"{candidates}); recovered from the RAM tier @step "
                               f"{info['snapshot_step']}")
                return f"ram://step{info['snapshot_step']}", {}
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
    # an emergency tag knows how far behind its stop boundary it was
    # captured; for a disk tag the caller diffs against its failing step
    engine._last_recovery = {"tier": tier, "snapshot_step": int(engine.global_steps),
                             "steps_lost": ((meta or {}).get("rewind") or {}).get(
                                 "steps_lost_at_save"),
                             "restore_s": round(time.perf_counter() - t_restore, 4)}
    if rewind_mgr is not None:
        rewind_mgr.note_recovery(engine._last_recovery)
    if skipped:
        log_dist(f"checkpoint fallback: restored {cand!r} after skipping {skipped} "
                 "(corrupt/unverified)", ranks=[0])
    log_dist(f"loaded checkpoint {cand} from {load_dir}", ranks=[0])
    return path, meta.get("client_state", {})


def load_inference_params(load_dir: str, model, dtype: torch.dtype, device,
                          tag: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Only the ``params`` field of a training tag, as ``model``'s state
    dict: floating tensors in the serving ``dtype``, all on ``device``.

    ``load_dir``: a training save dir (the tag by ``tag`` or its ``latest``
    file), or a tag dir itself. Every engine's tag holds whole
    ``params/<name>`` tensors (a save gathers the ZeRO partitions, and
    ZeRO-Infinity hands over its ``flat_state``), so a tag of any stage or
    placement serves the same model. Raises on a missing tag, and on params
    that are not ``model``'s names and shapes."""
    wait_for_pending_saves()
    if os.path.isdir(os.path.join(load_dir, STATE_DIR)):
        path = os.path.abspath(load_dir)          # a tag dir directly
    else:
        if tag is None:
            latest = os.path.join(os.path.abspath(load_dir), "latest")
            if not os.path.isfile(latest):
                raise FileNotFoundError(f"no 'latest' file in {load_dir}; pass tag= or a tag dir")
            with open(latest) as f:
                tag = f.read().strip()
        path = _ckpt_dir(load_dir, tag)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint {path} not found")
    params = {key[len("params/"):]: t for key, t in
              unstack_layers(read_state(path, ("params",), "cpu"), model).items()}
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    got = {n: tuple(t.shape) for n, t in params.items()}
    if got != want:
        raise ValueError(f"checkpoint {path} does not hold the model's params: missing "
                         f"{sorted(want.keys() - got.keys())}, unexpected "
                         f"{sorted(got.keys() - want.keys())}, other shapes "
                         f"{sorted(n for n in want.keys() & got.keys() if want[n] != got[n])}")
    log_dist(f"loaded serving params from {path}", ranks=[0])
    return {n: t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)
            for n, t in params.items()}


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
    every model's ``params_from_jax`` maps the params (GPT-2, llama and
    BERT tags alike); the other keys keep their names with ``.`` for
    ``/``, so a MoE tag's ``moe/...`` leaves stay stacked, as the port's
    tags hold them. The JAX engine's ``rng`` has no
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
