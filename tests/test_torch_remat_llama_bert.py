"""The remat policies of llama and BERT against the JAX package and
against remat off: the cases of ``test_torch_remat.py`` (its helpers and
checks) for those two families, in a file of their own so that it runs
beside GPT-2's.
"""

import pytest

from tests.test_torch_remat import CASES, check_flash_entry_calls, check_loss_and_grads

OTHER_CASES = [c for c in CASES if c[0] != "gpt2"]


@pytest.mark.parametrize("family,policy", OTHER_CASES)
def test_loss_and_grads_match_jax_and_remat_off(family, policy):
    check_loss_and_grads(family, policy)


@pytest.mark.parametrize("family,policy", OTHER_CASES)
def test_flash_entry_calls_per_step(monkeypatch, family, policy):
    check_flash_entry_calls(monkeypatch, family, policy)
