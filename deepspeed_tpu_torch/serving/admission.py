"""Admission control: the request object, structured shedding, KV sizing.

Counterpart of ``deepspeed_tpu/serving/admission.py``. The admission bound
says how many requests may exist (queued + in flight) before the server
says no, and it comes from memory: every admitted request will hold a KV
cache of :func:`kv_bytes_per_request` bytes, so the bound is
``kv_budget_fraction × (card memory − weights) ÷ per-request KV`` unless
the config pins ``max_queue_depth``. Saying no is an outcome of its own: a
:class:`ShedError` carries the queue depth, the estimated wait and a
retry-after hint, so a load balancer can back off.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.utils.logging import logger

# the memory to budget against when the device reports none (the CPU): the
# JAX package's fallback, one v5e chip's worth
DEFAULT_HBM_BYTES = 16 << 30


class ShedError(RuntimeError):
    """Structured admission rejection: why, how deep the queue is, how long
    the wait would have been, and when to retry."""

    def __init__(self, reason: str, queue_depth: int = 0,
                 est_wait_s: float = 0.0, retry_after_s: float = 0.0):
        self.reason = str(reason)
        self.queue_depth = int(queue_depth)
        self.est_wait_s = float(est_wait_s)
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"request shed ({self.reason}): queue_depth={self.queue_depth}, "
            f"est_wait={self.est_wait_s:.2f}s, "
            f"retry_after={self.retry_after_s:.2f}s")


# terminal request statuses: every admitted request ends in exactly one
TERMINAL_STATUSES = ("completed", "partial", "shed", "failed")


@dataclasses.dataclass
class Request:
    """One request's lifecycle record. Clients hold it after ``submit()``
    and wait on :meth:`result`; the front-end resolves it exactly once
    into a terminal status (completed / partial / shed / failed)."""

    prompt: Any                       # (1, T) int32 token ids (numpy)
    max_new_tokens: int = 32
    deadline_s: float = 30.0          # budget from submission, queue wait included
    id: str = ""
    stream: Optional[Callable[[List[int]], None]] = None
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    seed: int = 0
    is_probe: bool = False

    # lifecycle fields, owned by the front-end
    status: str = "queued"            # queued|running|<TERMINAL_STATUSES>
    reason: str = ""
    retry_after_s: float = 0.0        # back-off hint on a resolved shed
    tokens: List[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    ttft_s: Optional[float] = None
    _done: threading.Event = dataclasses.field(default_factory=threading.Event, repr=False)

    @property
    def deadline_at(self) -> float:
        return self.submitted_at + self.deadline_s

    def remaining_s(self, now: Optional[float] = None) -> float:
        return self.deadline_at - (time.monotonic() if now is None else now)

    def result(self, timeout: Optional[float] = None) -> "Request":
        """Block until the request reaches a terminal status; returns self.
        Raises TimeoutError if it is not resolved in time (a client guard:
        the front-end itself leaves no request unresolved)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id!r} not resolved within "
                               f"{timeout}s (status={self.status!r})")
        return self

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def to_dict(self) -> Dict[str, Any]:
        d = {"id": self.id, "status": self.status, "reason": self.reason,
             "tokens": list(self.tokens),
             "n_tokens": len(self.tokens),
             "ttft_s": self.ttft_s,
             "deadline_s": self.deadline_s,
             "latency_s": (None if self.finished_at is None
                           else self.finished_at - self.submitted_at)}
        if self.status == "shed" and self.retry_after_s:
            d["retry_after_s"] = self.retry_after_s
        return d


def kv_bytes_per_request(module, max_total_len: int) -> int:
    """KV-cache bytes one request holds at the serving cache size: the
    model's ``init_cache(1, max_total_len)`` built on the ``meta`` device,
    so nothing is allocated."""
    cache = module.init_cache(1, int(max_total_len), device="meta")
    return sum(t.numel() * t.element_size() for t in cache.values())


def _device_hbm_bytes(engine) -> Tuple[int, str]:
    """(memory bytes, source) of the engine's device: the card's total
    memory under the JAX source name ``memory_stats``; on the CPU
    ``DEFAULT_HBM_BYTES``, as the JAX package falls back."""
    if engine.device.type == "cuda":
        return int(torch.cuda.mem_get_info(engine.device)[1]), "memory_stats"
    return DEFAULT_HBM_BYTES, "fallback"


def resolve_capacity(engine, cfg) -> Tuple[int, Dict[str, Any]]:
    """The admission bound (queued + in-flight requests) and how it was
    derived. An explicit ``max_queue_depth`` wins; otherwise the bound is
    ``kv_budget_fraction × (memory − weight bytes)`` over the per-request
    KV bytes at the engine's ``max_out_tokens``. The weight bytes are
    ``engine.weight_nbytes()`` (quantized codes counted as stored)."""
    detail: Dict[str, Any] = {}
    if cfg.max_queue_depth > 0:
        detail["source"] = "max_queue_depth"
        detail["capacity"] = int(cfg.max_queue_depth)
        return int(cfg.max_queue_depth), detail

    max_len = int(engine._config.max_out_tokens)
    per_req = kv_bytes_per_request(engine.module, max_len)
    if cfg.hbm_bytes > 0:
        hbm, src = int(cfg.hbm_bytes), "config"
    else:
        hbm, src = _device_hbm_bytes(engine)
    params_bytes = int(engine.weight_nbytes())
    budget = max(0, hbm - params_bytes) * float(cfg.kv_budget_fraction)
    cap = max(1, int(budget // max(1, per_req)))
    detail.update({"source": f"kv_budget({src})", "capacity": cap,
                   "hbm_bytes": hbm, "params_bytes": params_bytes,
                   "kv_bytes_per_request": per_req,
                   "kv_budget_fraction": float(cfg.kv_budget_fraction),
                   "max_total_len": max_len})
    logger.info(f"serving admission: capacity={cap} requests "
                f"({per_req / 1e6:.1f}MB KV each at {max_len} tokens, "
                f"budget {budget / 1e9:.2f}GB of {hbm / 1e9:.2f}GB device memory)")
    return cap, detail
