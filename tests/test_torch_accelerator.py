"""The port's accelerator seam against the JAX package's.

Every public method of the JAX ``DeepSpeedAccelerator``, read from its
source with ``ast`` (importing it would need JAX's device runtime only for
the method names), is on the port's CUDA accelerator. On a host without a
card, the methods that answer without one give their values (the names,
zero devices, the seed, the types, the op builders: the port's four CUDA
sources and its aio library), and those whose answer is a fact of the card
raise instead of making one up. Their answers on the card are held by
``tests/test_torch_cuda.py``.
"""

import ast
import os

import pytest
import torch

from deepspeed_tpu_torch.accelerator import abstract_accelerator, get_accelerator
from deepspeed_tpu_torch.accelerator.cuda_accelerator import CUDA_Accelerator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SEAM = os.path.join(REPO, "deepspeed_tpu", "accelerator", "abstract_accelerator.py")


def _public_methods(path: str, cls: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    node, = (n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == cls)
    return {f.name for f in node.body
            if isinstance(f, ast.FunctionDef) and not f.name.startswith("_")}


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the answers without one are what is tested")


def test_every_public_method_of_the_jax_seam():
    jax_methods = _public_methods(JAX_SEAM, "DeepSpeedAccelerator")
    port_methods = _public_methods(abstract_accelerator.__file__, "DeepSpeedAccelerator")
    assert len(jax_methods) == 26
    assert jax_methods <= port_methods, sorted(jax_methods - port_methods)
    accel = get_accelerator()
    assert isinstance(accel, CUDA_Accelerator)
    assert all(callable(getattr(accel, m)) for m in jax_methods)
    assert not CUDA_Accelerator.__abstractmethods__


@pytest.mark.parametrize("method,args,want", [
    ("name", (), "cuda"), ("device_name", (), "cuda"), ("device_name", (1,), "cuda:1"),
    ("device", (2,), torch.device("cuda", 2)), ("is_available", (), False),
    ("device_count", (), 0), ("global_device_count", (), 0),
    ("communication_backend_name", (), "nccl"), ("preferred_dtype", (), torch.bfloat16),
    ("supported_dtypes", (), [torch.float32, torch.bfloat16, torch.float16, torch.int8,
                              torch.int32]),
    ("on_accelerator", (torch.ones(2),), False), ("on_accelerator", ([1.0],), False),
    ("get_op_builder", ("no_such_op",), None), ("create_op_builder", ("no_such_op",), None)])
def test_answers_without_a_card(method, args, want):
    _no_card()
    assert getattr(get_accelerator(), method)(*args) == want


def test_seed_is_the_hosts_and_every_cards():
    state = torch.get_rng_state()
    try:
        gen = get_accelerator().manual_seed(1234)
        assert gen is torch.default_generator
        assert get_accelerator().initial_seed() == 1234 == torch.initial_seed()
    finally:
        torch.set_rng_state(state)


def test_op_builders_are_the_ports_libraries():
    from deepspeed_tpu_torch.ops import aio
    from deepspeed_tpu_torch.ops.pallas import decode_attention as da
    from deepspeed_tpu_torch.ops.pallas import flash_attention as fa

    accel = get_accelerator()
    want = {"flash_attention_fwd": fa.KERNEL, "flash_attention_bwd": fa.BWD_KERNEL,
            "decode_attention": da.KERNEL, "sparse_attention": fa.SPARSE_KERNEL,
            "async_io": aio.LIBRARY}
    assert {name: accel.get_op_builder(name) for name in want} == want
    for kern in (fa.KERNEL, fa.BWD_KERNEL, da.KERNEL, fa.SPARSE_KERNEL):
        assert kern.source.is_file()
    built = accel.create_op_builder("async_io")     # g++, no card needed
    assert built is aio.LIBRARY and built.library_path.is_file()


@pytest.mark.parametrize("method,args", [
    ("set_device", (0,)), ("total_memory", ()), ("available_memory", ()),
    ("memory_stats", ()), ("is_bf16_supported", ()), ("is_fp16_supported", ()),
    ("create_op_builder", ("decode_attention",))])
def test_facts_of_the_card_raise_without_one(method, args):
    _no_card()
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        getattr(get_accelerator(), method)(*args)
