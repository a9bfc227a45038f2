"""Resilience: verified checkpoints, hang and desync detection, drills and
the rewind ladder.

Counterpart of ``deepspeed_tpu/resilience/``: ``retry`` (backoff with
jitter and a deadline around filesystem calls; the elastic agent's restart
backoff), ``fsio`` (temp file, fsync, rename, through the chaos hooks),
``manifest`` (written at save, verified before restore), ``watchdog`` (the
step watchdog, ``run_with_deadline``, stack dumps, the heartbeat file),
``consistency`` (the config fingerprint at init, the step agreement),
``chaos`` (the seedable fault injector), ``sentinel`` (the bad-step
sentinel) and ``rewind`` (the host-RAM ring, emergency tags). The package
imports none of them: the engine imports each only with its block. The
silent-data-corruption and fail-slow defences (``sdc``, ``gray``) need
several devices and are later slices.
"""
