"""The profiling layer: the flops profiler, the memory profiler and the
offline renderers.

* ``flops_profiler/``: the matmul and convolution flops of a step, counted
  as it runs, by module (``FlopsProfiler``, ``get_model_profile``; both
  exported here, lazily);
* ``memory.py``: the census of the card's allocated bytes by the engine's
  state, per-span peak deltas and the leak sentinel (the ``profiling``
  ds_config block);
* ``report.py``: text views of a run's telemetry (memory, serving);
* ``scaling.py``: the step breakdown and the many-card projection.

Nothing is imported with the package: an engine without the
``flops_profiler`` or ``profiling`` block never imports
``flops_profiler.profiler`` or ``memory``, and reading a report does not
import the profilers.
"""

_LAZY = {"FlopsProfiler": "deepspeed_tpu_torch.profiling.flops_profiler.profiler",
         "get_model_profile": "deepspeed_tpu_torch.profiling.flops_profiler.profiler"}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
