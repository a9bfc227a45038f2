"""Compression training under ZeRO stage 3 with ``offload_param: cpu``
against the JAX package: every unit fetched from host memory, the
compressed values of the armed leaves written into host-memory copies of
the units' parts that the gathers copy from. The same six steps,
``redundancy_clean`` and checks as ``test_torch_compression_zero3.py``, on
one rank and on two spawned gloo ranks, held to the JAX engine at stage 3
with ``offload_param`` and to the port's stage-1 run bit for bit.

The ranks import no JAX: this module imports it inside its functions.
"""

import pytest

from tests.test_torch_compression_zero3 import held_to_jax, held_to_stage_1, placement_runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return placement_runs(str(tmp_path_factory.mktemp("compression_offload")),
                          ("stage1", "stage3_offload"), "stage3_offload")


@pytest.mark.parametrize("world", ["one", "two"])
def test_losses_and_params_match_the_jax_engine(runs, world):
    held_to_jax(runs, "stage3_offload", world)


def test_offload_param_fetches_every_unit(runs):
    fetched, units = runs["one"]["stage3_offload"]["fetched"]
    assert fetched == units


@pytest.mark.parametrize("world", ["one", "two"])
def test_offloaded_stage_3_equals_stage_1_bit_for_bit(runs, world):
    held_to_stage_1(runs, "stage3_offload", world)


def test_compressed_values_are_served_from_host_memory(runs):
    """The served copies sit where the raw parts do: in host memory."""
    assert runs["one"]["stage3_offload"]["served_devices"] == {"cpu"}
