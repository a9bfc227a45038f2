"""Bad-step sentinel: stop burning the job on a diverged run.

Counterpart of ``deepspeed_tpu/resilience/sentinel.py``, the same rule. The
loss scaler skips non-finite steps, but a diverged or data-poisoned run
skips forever. The sentinel watches each step's host-side loss and overflow
flag and, after ``patience`` consecutive bad steps (a non-finite loss, an
overflow-skipped update after the first clean step, or a loss above
``spike_factor`` times the recent good mean), tells the engine to rewind
through the snapshot ladder. ``max_rewinds`` bounds the
rewind, diverge, rewind loop; past it the engine raises
:class:`BadStepError` for the elastic agent or the launcher.
"""

from __future__ import annotations

import math
from collections import deque


class BadStepError(RuntimeError):
    """The sentinel gave up: bad steps persisted past the rewind budget
    (or there is no checkpoint to rewind to)."""


class BadStepSentinel:
    def __init__(self, patience: int = 3, spike_factor: float = 0.0,
                 window: int = 20, max_rewinds: int = 2):
        if patience < 1:
            raise ValueError("sentinel patience must be >= 1")
        self.patience = int(patience)
        self.spike_factor = float(spike_factor)
        self.window = int(window)
        self.max_rewinds = int(max_rewinds)
        self.bad_streak = 0
        self.trips = 0
        self.last_reason = ""
        self._good = deque(maxlen=self.window)
        self._seen_good = False

    def observe(self, loss: float, overflow: bool = False) -> bool:
        """Feed one step's (host-side) loss and overflow flag. Returns True
        when the bad streak just reached ``patience`` — i.e. rewind now."""
        reason = None
        if overflow:
            if not self._seen_good:
                # dynamic loss-scale warmup: a fresh fp16 run legitimately
                # overflows for its first several steps while the scale
                # halves down from its high initial value — only overflows
                # AFTER the first clean step indicate divergence
                return False
            reason = "overflow-skipped step"
        elif not math.isfinite(loss):
            reason = f"non-finite loss ({loss})"
        elif self.spike_factor > 0 and len(self._good) >= max(2, self.window // 4):
            mean = sum(self._good) / len(self._good)
            if mean > 0 and loss > self.spike_factor * mean:
                reason = (f"loss spike ({loss:.4g} > {self.spike_factor:g}× "
                          f"recent mean {mean:.4g})")
        if reason is None:
            self.bad_streak = 0
            self._seen_good = True
            self._good.append(loss)
            return False
        self.bad_streak += 1
        self.last_reason = reason
        if self.bad_streak >= self.patience:
            self.trips += 1
            self.bad_streak = 0
            return True
        return False

    def reset(self):
        """After a rewind: forget the streak AND the loss history (the
        rewound run re-treads steps whose stats no longer apply).
        ``_seen_good`` survives — the restored loss scale had already
        settled, so post-rewind overflows are real divergence signals."""
        self.bad_streak = 0
        self._good.clear()
