"""Fault-tolerant serving front-end over the inference engine.

Counterpart of ``deepspeed_tpu/serving/``. A bare ``generate()`` has no
answer for a queue that outgrows memory, a decode step that fails or
hangs, or a SIGTERM mid-stream. The contract here: **every admitted
request terminates deterministically**, with tokens, with a partial and a
reason, or with a structured shed. Nothing is silently dropped and the
process never wedges.

* :class:`~deepspeed_tpu_torch.serving.frontend.ServingFrontEnd`: the
  request lifecycle manager (bounded admission sized from the KV-cache
  memory budget, per-request deadlines at admission and at every decode
  tick under ``run_with_deadline``, a circuit breaker around the engine,
  graceful drain on SIGTERM or preemption with exit code 87).
* :class:`~deepspeed_tpu_torch.serving.admission.Request` /
  :class:`~deepspeed_tpu_torch.serving.admission.ShedError`: the request
  clients hold and the structured rejection they get under overload.
* :class:`~deepspeed_tpu_torch.serving.breaker.CircuitBreaker`.
* ``python -m deepspeed_tpu_torch.serving.cli``: serve a request trace,
  render the status view, or ``--smoke`` the whole pipeline.

Enabled by the ``serving`` ds_config block. Nothing else in the port
imports this package, so a config without the block starts no thread.
Failure paths are drillable through the chaos injector's ``decode_step``
hook (``resilience/chaos.py``).
"""

from deepspeed_tpu_torch.serving.admission import (Request, ShedError, kv_bytes_per_request,
                                                   resolve_capacity)
from deepspeed_tpu_torch.serving.breaker import CircuitBreaker
from deepspeed_tpu_torch.serving.frontend import (DRAIN_EXIT_CODE, ServerState, ServingFrontEnd,
                                                  from_ds_config)

__all__ = [
    "Request", "ShedError", "CircuitBreaker", "ServerState",
    "ServingFrontEnd", "from_ds_config", "resolve_capacity",
    "kv_bytes_per_request", "DRAIN_EXIT_CODE",
]
