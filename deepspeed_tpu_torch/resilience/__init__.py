"""Verified checkpoints: retried I/O, atomic writes and per-tag manifests.

Counterpart of the part of ``deepspeed_tpu/resilience/`` the checkpoint
engine needs: ``retry`` (backoff with jitter and a deadline around
filesystem calls), ``fsio`` (temp file, fsync, rename) and ``manifest``
(written at save, verified before restore); ``watchdog`` (the
``run_with_deadline`` the serving front-end's ticks run under) and
``chaos`` (the injector of the ``decode_step`` faults). The step watchdog,
the other fault classes, the bad-step sentinel and the rewind tiers are
later slices.
"""
