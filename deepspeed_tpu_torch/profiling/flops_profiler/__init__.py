"""The flops profiler (``profiler.py``)."""

from deepspeed_tpu_torch.profiling.flops_profiler.profiler import (FlopCounter,  # noqa: F401
                                                                   FlopsProfiler,
                                                                   flops_to_string,
                                                                   get_model_profile,
                                                                   macs_to_string,
                                                                   number_to_string,
                                                                   params_to_string)
