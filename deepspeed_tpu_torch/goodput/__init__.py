"""Goodput and badput accounting: where every wall-second of a job went.

Counterpart of ``deepspeed_tpu/goodput/``. Of the wall time a job burned,
how much was training compute, and how much compile, exposed
communication, data wait, checkpoint I/O, watchdog stalls, straggler wait,
restart downtime or idle? The package composes the telemetry step spans,
the comm layer's rank-matchable collective spans
(``profiling/aggregate.py``) and the elastic agent's ``restart_log.jsonl``
into a closed time ledger:

* ``taxonomy``: the buckets and the priority order that makes the
  partition disjoint (every second in exactly one bucket);
* ``ledger``: per-step and per-session classification of one rank's
  trace events;
* ``report``: the job's view, sessions stitched across elastic restarts on
  their clock anchors, the gaps charged to ``restart``
  (``python -m deepspeed_tpu_torch.profiling.cli goodput DIR``);
* ``recorder``: the engine's meter (the ``goodput`` ds_config block), the
  ``goodput/*`` series and the compile spans;
* ``tail`` and ``top``: the JSONL follower and the live view
  (``python -m deepspeed_tpu_torch.goodput.top DIR``).

All but ``recorder`` are standard library only. Without the ``goodput``
block the engine never imports this package.
"""

from __future__ import annotations

from deepspeed_tpu_torch.goodput.taxonomy import BADPUT_BUCKETS, BUCKETS, GOODPUT_BUCKETS

__all__ = ["BUCKETS", "GOODPUT_BUCKETS", "BADPUT_BUCKETS"]
