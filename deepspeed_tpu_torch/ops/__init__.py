"""The port's device kernels: CUDA C++ sources in ``csrc/``, built by
:mod:`deepspeed_tpu_torch.ops.op_builder`, wrapped in ``ops/pallas/``."""
