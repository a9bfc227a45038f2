"""Verified checkpoints: retried I/O, atomic writes and per-tag manifests.

Counterpart of the part of ``deepspeed_tpu/resilience/`` the checkpoint
engine needs: ``retry`` (backoff with jitter and a deadline around
filesystem calls), ``fsio`` (temp file, fsync, rename) and ``manifest``
(written at save, verified before restore). The chaos injector, the
bad-step sentinel, the watchdog and the rewind tiers are later slices.
"""
