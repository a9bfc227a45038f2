"""Wrappers of the port's hand-written CUDA kernels.

The directory keeps the name of ``deepspeed_tpu/ops/pallas/`` so that each
module sits at its counterpart's path; the kernels themselves are CUDA C++
in ``deepspeed_tpu_torch/csrc/``, not Pallas.
"""
