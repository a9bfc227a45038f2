"""The port's HF exporters and consolidated HF files, against the JAX package.

``export_gpt2`` / ``export_llama`` / ``export_bloom`` take the port's
per-layer state dict (or a model) and give the JAX exporters' dicts for the
same weights (stacked into the JAX tree), numpy arrays key for key and bit
for bit; each loads back through its loader bit for bit (llama from fp32
and from bf16, GPT-2 and BLOOM tied and untied). ``state_dict_to_tree``
nests as the JAX one does. ``consolidate_to_file(arch=...)`` of a port tag
writes, for gpt2, opt, llama and bloom, the file the JAX function writes
from the same weights, key for key and value for value; ``python -m
deepspeed_tpu_torch.runtime.checkpoint_engine.consolidate`` writes it too,
with the JAX tool's output lines.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.module_inject import hf as thf
from deepspeed_tpu_torch.runtime.checkpoint_engine import consolidate as tcons
from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import wait_for_pending_saves
from tests.test_torch_model_import import (D, H, L, P, V, _jax_tree, _obj, _torch_sd, hf_bert,
                                           hf_llama)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- exporters
def _bloom_sd(seed=5):
    cfg = tgpt2.GPT2Config(vocab_size=V, n_positions=P, n_embd=D, n_layer=L, n_head=H,
                           alibi=True, embed_layernorm=True, activation="gelu_new",
                           dtype=torch.float32)
    return cfg, tgpt2.GPT2Model(cfg).init_params(torch.Generator().manual_seed(seed)).state_dict()


def _gpt2_sd(tied, seed=6):
    cfg = tgpt2.GPT2Config(vocab_size=V, n_positions=P, n_embd=D, n_layer=L, n_head=H,
                           tie_embeddings=tied, dtype=torch.float32)
    return cfg, tgpt2.GPT2Model(cfg).init_params(torch.Generator().manual_seed(seed)).state_dict()


def _same_dicts(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def _same_state(got, want):
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_export_gpt2_and_bloom_round_trip_and_match_jax(tied):
    from deepspeed_tpu.module_inject import hf as jhf

    cfg, sd = _gpt2_sd(tied)
    exported = thf.export_gpt2(sd)
    _same_dicts(exported, jhf.export_gpt2(_jax_tree(sd)))
    _, back = thf.load_gpt2(_obj({"n_head": H}, exported))
    _same_state(back, sd)
    bcfg, bsd = _bloom_sd()
    if not tied:
        bsd["lm_head"] = torch.randn(D, V, generator=torch.Generator().manual_seed(9))
    exported = thf.export_bloom(tgpt2.GPT2Model(bcfg).init_params(
        torch.Generator().manual_seed(5)) if tied else bsd, n_head=H)
    _same_dicts(exported, jhf.export_bloom(_jax_tree(bsd), n_head=H))
    bc, back = thf.load_bloom(_obj({"model_type": "bloom", "n_head": H}, exported))
    _same_state(back, bsd)
    assert bc.alibi and bc.embed_layernorm and bc.tie_embeddings == tied


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_export_llama_round_trips_bit_for_bit(tied):
    from deepspeed_tpu.module_inject import hf as jhf

    cfg, sd = hf_llama(seed=4, tied=tied)
    _, tsd = thf.load_llama(_obj(cfg, _torch_sd(sd)))
    exported = thf.export_llama(tsd)
    _same_dicts(exported, sd)                         # the HF dict itself
    _same_dicts(exported, jhf.export_llama(_jax_tree(tsd)))
    _, back = thf.load_llama(_obj(cfg, exported))
    _same_state(back, tsd)
    # bf16 weights export widened to fp32 and load back in bf16, exactly
    _, bf = thf.load_llama(_obj(cfg, _torch_sd(sd)), dtype=torch.bfloat16)
    _, back = thf.load_llama(_obj(cfg, thf.export_llama(bf)), dtype=torch.bfloat16)
    _same_state(back, bf)


def test_state_dict_to_tree_matches_jax():
    from deepspeed_tpu.module_inject import hf as jhf

    sd = hf_bert()[1]
    got, want = thf.state_dict_to_tree(sd), jhf.state_dict_to_tree(sd)

    def walk(a, b):
        assert type(a) is type(b)
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                walk(a[k], b[k])
        else:
            assert a is b
    walk(got, want)


# ------------------------------------------------------------ consolidation
def _saved_tag(model, path):
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config={"train_batch_size": 2, "steps_per_print": 0,
                             "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}},
        device="cpu")
    engine.save_checkpoint(path)
    wait_for_pending_saves()
    return str(path)


def test_consolidate_to_file_arch_matches_jax_and_the_tool(tmp_path, monkeypatch):
    from deepspeed_tpu.runtime.checkpoint_engine import consolidate as jcons

    from deepspeed_tpu_torch.models.llama import LlamaModel

    lcfg, lsd = thf.load_llama(_obj(*hf_llama(seed=7, tied=False)))
    llama = LlamaModel(lcfg)
    llama.load_state_dict({k: v.clone() for k, v in lsd.items()}, assign=True)
    bcfg, bsd = _bloom_sd()
    bloom = tgpt2.GPT2Model(bcfg)
    bloom.load_state_dict({k: v.clone() for k, v in bsd.items()}, assign=True)
    tags = {"llama": (_saved_tag(llama, tmp_path / "llama"), lsd),
            "bloom": (_saved_tag(bloom, tmp_path / "bloom"), bsd)}
    for arch, source in (("gpt2", "bloom"), ("opt", "bloom"), ("llama", "llama"),
                         ("bloom", "bloom")):
        ckpt, sd = tags[source]
        got = tcons.consolidate_to_file(ckpt, str(tmp_path / f"t_{arch}"), arch=arch, n_head=H)
        # the JAX function's export of the same weights (its orbax read
        # replaced by the weights the port's tag was saved from)
        monkeypatch.setattr(jcons, "consolidated_fp32_params",
                            lambda *a, sd=sd, **k: _jax_tree(sd))
        want = jcons.consolidate_to_file(ckpt, str(tmp_path / f"j_{arch}"), arch=arch,
                                         n_head=H)
        with np.load(got) as a, np.load(want) as b:
            _same_dicts(dict(a), dict(b))
    with pytest.raises(ValueError, match="no exporter for arch 'mpt'"):
        tcons.consolidate_to_file(tags["llama"][0], str(tmp_path / "x"), arch="mpt")
    with pytest.raises(ValueError, match="needs n_head"):
        tcons.consolidate_to_file(tags["bloom"][0], str(tmp_path / "x"), arch="bloom")
    out = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.runtime.checkpoint_engine.consolidate",
         tags["bloom"][0], str(tmp_path / "cli"), "--arch", "bloom", "--n-head", str(H)],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "checkpoint: step=0 zero_stage=0 dp=1"
    assert lines[-1] == f"wrote {tmp_path / 'cli.npz'}"
    with np.load(tmp_path / "cli.npz") as a, np.load(tmp_path / "t_bloom.npz") as b:
        _same_dicts(dict(a), dict(b))
