"""Per-tag checkpoint manifests: written at save, verified before restore.

Counterpart of ``deepspeed_tpu/resilience/manifest.py``, with the same
``manifest.json`` fields and acceptance rules. A tag directory is verified
when its manifest, written after the ``state/`` tree commits and before the
``latest`` pointer advances, matches the disk:

* sha256 and byte size of ``client_state.json`` and every sidecar, hashed
  from the in-memory payload at save time, so a write that landed
  truncated or corrupt is caught although it "succeeded";
* byte size of every file under ``state/`` (hashing gigabytes of state on
  every load would double the restore time);
* the commit marker ``state/_CHECKPOINT_METADATA``, which the port's
  checkpoint engine writes after every ``state/`` file is fsynced.

``candidate_tags`` orders tags newest first, so a restart resumes at the
newest tag that passes. The JAX module also counts verification failures
in its telemetry registry; telemetry is a later slice of the port.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Dict, List, Optional, Tuple

from deepspeed_tpu_torch.resilience.fsio import atomic_write_json
from deepspeed_tpu_torch.resilience.retry import RetryPolicy
from deepspeed_tpu_torch.utils.logging import logger

MANIFEST_NAME = "manifest.json"
STATE_DIR = "state"
COMMIT_MARKER = os.path.join(STATE_DIR, "_CHECKPOINT_METADATA")
SAMPLER_SIDECAR = "data_sampler_admitted.npy"
_STEP_RE = re.compile(r"(\d+)\s*$")


def sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _walk_sizes(root: str, rel_prefix: str) -> Dict[str, int]:
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            out[os.path.join(rel_prefix, os.path.relpath(p, root))] = os.path.getsize(p)
    return out


def write_manifest(tag_dir: str, tag: str, files: Dict[str, bytes],
                   policy: Optional[RetryPolicy] = None, advance_latest: bool = True) -> dict:
    """Write ``<tag_dir>/manifest.json``. ``files`` maps each sidecar's name
    to the exact bytes meant for it; the committed ``state/`` tree is sized
    from the disk. ``advance_latest`` records whether the save meant to move
    ``latest``: it tells a save that died before the pointer moved (resume
    from it) from a ``save_latest=False`` side checkpoint (never resumed
    automatically)."""
    manifest = {
        "version": 1,
        "tag": tag,
        "advance_latest": bool(advance_latest),
        "commit_marker": COMMIT_MARKER.replace(os.sep, "/"),
        "files": {name: {"bytes": len(data), "sha256": sha256_bytes(data)}
                  for name, data in files.items()},
        "state_files": {k.replace(os.sep, "/"): v
                        for k, v in _walk_sizes(os.path.join(tag_dir, STATE_DIR),
                                                STATE_DIR).items()},
    }
    atomic_write_json(os.path.join(tag_dir, MANIFEST_NAME), manifest, op="manifest",
                      policy=policy, sort_keys=True)
    return manifest


def _is_own_leftover(name: str) -> bool:
    """Our metadata, or a temp file or directory of a save that died: none
    of these is a foreign engine's payload."""
    return name in ("client_state.json", MANIFEST_NAME, SAMPLER_SIDECAR) \
        or ".tmp." in name or "orbax-checkpoint-tmp" in name


def verify_tag(tag_dir: str) -> Tuple[bool, str]:
    """Is this tag safe to restore? Returns (ok, reason).

    A tag without ``manifest.json`` predates the manifests: it is accepted
    when the commit marker is present and ``client_state.json`` parses. A
    layout with no ``state/`` tree at all (another engine's snapshot files)
    is accepted when ``client_state.json`` parses and payload files lie
    beside it. A save that died between the state commit and the metadata
    has neither file and is rejected."""
    if not os.path.isdir(tag_dir):
        return False, "tag directory does not exist"
    marker = os.path.join(tag_dir, COMMIT_MARKER)
    mpath = os.path.join(tag_dir, MANIFEST_NAME)
    if not os.path.isfile(mpath):
        cs = os.path.join(tag_dir, "client_state.json")
        if not os.path.isfile(cs):
            return False, "no manifest and no client_state.json (save died mid-metadata)"
        try:
            with open(cs) as f:
                json.load(f)
        except (OSError, ValueError) as e:
            return False, f"no manifest and client_state.json unparseable ({e})"
        if os.path.isfile(marker):
            return True, "no manifest (pre-manifest tag accepted: commit marker + client state intact)"
        if not os.path.isdir(os.path.join(tag_dir, STATE_DIR)):
            if [n for n in os.listdir(tag_dir) if not _is_own_leftover(n)]:
                return True, ("no manifest (non-orbax layout accepted: "
                              "client state + payload files intact)")
        return False, "state never committed (missing state/_CHECKPOINT_METADATA)"
    if not os.path.isfile(marker):
        return False, "state never committed (missing state/_CHECKPOINT_METADATA)"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"manifest unreadable ({e})"
    try:
        for name, want in manifest.get("files", {}).items():
            p = os.path.join(tag_dir, name)
            if not os.path.isfile(p):
                return False, f"{name} missing"
            size = os.path.getsize(p)
            if size != want.get("bytes"):
                return False, f"{name} is {size}B, manifest says {want.get('bytes')}B"
            if _sha256_file(p) != want.get("sha256"):
                return False, f"{name} sha256 mismatch (corrupt or truncated write)"
        for rel, want_size in manifest.get("state_files", {}).items():
            p = os.path.join(tag_dir, rel.replace("/", os.sep))
            if not os.path.isfile(p):
                return False, f"state file {rel} missing"
            size = os.path.getsize(p)
            if size != want_size:
                return False, f"state file {rel} is {size}B, manifest says {want_size}B"
    except OSError as e:
        # a file pruned or lost between the check and the read: the tag
        # cannot be restored, which is not a crash
        return False, f"filesystem error while verifying ({e})"
    return True, "ok"


def tag_step(tag: str) -> int:
    """The training step a tag's name ends in (``global_step<N>``), -1 when
    it ends in none."""
    m = _STEP_RE.search(tag)
    return int(m.group(1)) if m else -1


def _tag_sort_key(save_dir: str, tag: str):
    """Newest first: by the step in the name, then by directory mtime."""
    try:
        mtime = os.path.getmtime(os.path.join(save_dir, tag))
    except OSError:
        mtime = 0.0
    return (tag_step(tag), mtime)


def _intends_latest(save_dir: str, tag: str) -> bool:
    """Did this tag's save mean to advance ``latest``? A tag without a
    readable manifest counts as yes."""
    try:
        with open(os.path.join(save_dir, tag, MANIFEST_NAME)) as f:
            return bool(json.load(f).get("advance_latest", True))
    except (OSError, ValueError):
        return True


def candidate_tags(save_dir: str, preferred: Optional[str] = None) -> List[str]:
    """The tag directories under ``save_dir`` in restore order:

    1. ``preferred``, when given and present;
    2. the tags saved to advance ``latest``, newest first. The tag
       ``latest`` names is outranked only by tags provably newer (both
       names carry a step and theirs is greater), so a save that died
       between its state commit and the pointer still wins, while a tag
       named without a step (``tag='best'``) or ranked by mtime alone is
       neither lifted above nor pushed below the pointer.

    ``save_latest=False`` side checkpoints are candidates only when asked
    for by name."""
    save_dir = os.path.abspath(save_dir)
    if not os.path.isdir(save_dir):
        return []
    tags = [d for d in os.listdir(save_dir)
            if os.path.isdir(os.path.join(save_dir, d)) and not d.startswith(".")]
    tags = [t for t in tags if t == preferred or _intends_latest(save_dir, t)]
    tags.sort(key=lambda t: _tag_sort_key(save_dir, t), reverse=True)
    latest = read_latest(save_dir)
    if latest in tags and latest != preferred:
        lstep = tag_step(latest)

        def provably_newer(t: str) -> bool:
            step = tag_step(t)
            return step >= 0 and lstep >= 0 and step > lstep

        tags = ([t for t in tags if provably_newer(t)] + [latest]
                + [t for t in tags if t != latest and not provably_newer(t)])
    if preferred is not None and preferred in tags:
        tags.remove(preferred)
        tags.insert(0, preferred)
    return tags


def read_latest(save_dir: str) -> Optional[str]:
    try:
        with open(os.path.join(os.path.abspath(save_dir), "latest")) as f:
            tag = f.read().strip()
        return tag or None
    except OSError:
        return None


def find_restorable_tag(save_dir: str, preferred: Optional[str] = None) -> Optional[str]:
    """The newest tag that passes :func:`verify_tag`, or None: a save
    directory holds a checkpoint only if something in it can be restored."""
    for tag in candidate_tags(save_dir, preferred=preferred):
        ok, reason = verify_tag(os.path.join(os.path.abspath(save_dir), tag))
        if ok:
            return tag
        logger.warning(f"checkpoint tag {tag!r} not restorable: {reason}")
    return None
