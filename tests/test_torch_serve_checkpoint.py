"""Serving a training tag: ``init_inference(config={"checkpoint": ...})``.

A 2-layer fp32 GPT-2 trains 3 steps on the CPU from one set of initial
weights and one batch, and saves a tag; ``init_inference`` serves it. The
served params equal the engine's bit for bit and give ``engine.module``'s
logits bit for bit. A tag dir given directly and ``checkpoint_config``'s
``tag`` pick an older tag; a save dir without ``latest`` and a missing tag
raise ``FileNotFoundError`` with the JAX package's messages
(``load_inference_params``); params of another model are refused; a
Megatron ``checkpoint_config.type`` serves a Megatron-DeepSpeed directory
(``model`` None builds the model; without ``n_head`` it raises, and
without a Megatron checkpoint ``model`` None raises);
``params`` takes precedence over ``checkpoint``, as in JAX. Tags saved at
ZeRO stage 3 over two gloo ranks and by the layerwise ``ZeroInfinityEngine``
(NVMe) hold whole params like stage 0's and serve its logits (fp32: 1e-5
of the largest, the summation order of two ranks and of the host's AdamW).

This module imports JAX only inside its functions: the spawned ranks
import it.
"""

import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.models.gpt2_moe import MoEGPT2
from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import wait_for_pending_saves
from tests.torch_megatron_files import write_megatron
from tests.torch_world import World

SMALL = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2, n_head=2, remat=False,
             dtype=torch.float32)
STEPS = 3
SERVE = {"dtype": "float32", "max_out_tokens": 32}
LOGIT_RTOL = 1e-5


def _config(stage, **zero):
    return {"train_batch_size": 4, "steps_per_print": 0,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage, **zero}}


def _batch():
    return {"input_ids": torch.from_numpy(np.random.RandomState(6).randint(
        0, SMALL["vocab_size"], size=(4, 16)).astype(np.int64))}


def _prompt():
    return torch.from_numpy(np.random.RandomState(7).randint(
        0, SMALL["vocab_size"], size=(2, 12)).astype(np.int64))


def _init_weights():
    return gpt2.GPT2Model(gpt2.GPT2Config(**SMALL)).init_params(
        torch.Generator().manual_seed(5)).state_dict()


def _train(config, save_dir, weights, save_every_step=False):
    model = gpt2.GPT2Model(gpt2.GPT2Config(**SMALL))
    model.load_state_dict({n: t.clone() for n, t in weights.items()}, assign=True)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu")
    for _ in range(STEPS):
        engine.train_batch(_batch())
        if save_every_step:
            engine.save_checkpoint(save_dir)
    if not save_every_step:
        engine.save_checkpoint(save_dir)
    wait_for_pending_saves()
    return engine


def _stage3_rank(rank, world, out_dir, weights_path):
    weights = torch.load(weights_path)
    _train(_config(3, stage3_param_persistence_threshold=0), os.path.join(out_dir, "tag"),
           weights)
    return rank


def _serve(checkpoint, **config):
    return deepspeed_tpu_torch.init_inference(gpt2.GPT2Model(gpt2.GPT2Config(**SMALL)),
                                              {**SERVE, "checkpoint": checkpoint, **config},
                                              device="cpu")


@pytest.fixture(scope="module")
def tags(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_ckpt")
    weights = _init_weights()
    torch.save(weights, root / "weights.pt")
    world = World(_stage3_rank, 2, str(root / "zero3"), args=(str(root / "weights.pt"),))
    engine = _train(_config(0), str(root / "zero0"), weights, save_every_step=True)
    infinity = _train(_config(3, offload_param={"device": "nvme",
                                                "nvme_path": str(root / "nvme")}),
                      str(root / "infinity"), weights)
    world.join()
    return {"root": root, "engine": engine, "infinity": infinity,
            "latest": (root / "zero0" / "latest").read_text().strip()}


def test_served_params_and_logits_are_the_engines_bit_for_bit(tags):
    engine = tags["engine"]
    served = _serve(str(tags["root"] / "zero0"))
    want = engine.module_state_dict()
    got = dict(served.module.named_parameters())
    assert got.keys() == want.keys() and tags["latest"] == f"global_step{STEPS}"
    for name, p in got.items():
        assert torch.equal(p, want[name]), name
    ids = _prompt()
    with torch.no_grad():
        assert torch.equal(served(ids), engine.module.apply(ids))
    out = served.generate(ids, max_new_tokens=4)
    assert tuple(out.shape) == (2, 16) and torch.equal(out[:, :12], ids)


def test_tag_dir_and_checkpoint_config_tag_pick_an_older_tag(tags):
    save_dir = tags["root"] / "zero0"
    by_dir = _serve(str(save_dir / "global_step1"))
    by_tag = _serve(str(save_dir), checkpoint_config={"tag": "global_step1"})
    latest = _serve(str(save_dir))
    ids = _prompt()
    a, b, c = by_dir(ids), by_tag(ids), latest(ids)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_missing_latest_and_missing_tag_raise_like_jax(tmp_path):
    from deepspeed_tpu.runtime.checkpoint_engine.engine import \
        load_inference_params as jax_load

    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import load_inference_params

    model = gpt2.GPT2Model(gpt2.GPT2Config(**SMALL))
    for tag in (None, "global_step9"):
        with pytest.raises(FileNotFoundError) as want:
            jax_load(str(tmp_path), None, tag=tag)
        with pytest.raises(FileNotFoundError) as got:
            load_inference_params(str(tmp_path), model, torch.float32, "cpu", tag=tag)
        assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError, match="no 'latest' file"):
        _serve(str(tmp_path))


def test_params_of_another_model_are_refused(tags):
    other = gpt2.GPT2Model(gpt2.GPT2Config(**{**SMALL, "n_layer": 3}))
    with pytest.raises(ValueError, match=r"missing \['blocks\.2\.fc2_b'"):
        deepspeed_tpu_torch.init_inference(other, {**SERVE,
                                                   "checkpoint": str(tags["root"] / "zero0")},
                                           device="cpu")


@pytest.mark.parametrize("kind", ["Megatron", "megatron_moe", "Megatron-MoE"])
def test_megatron_checkpoint_type_raises(tmp_path, kind):
    """A Megatron ``checkpoint_config.type`` without ``n_head`` raises the
    JAX package's ValueError; with it, the directory serves: a model built
    from the files (none given) gives the logits of the written weights
    served from ``params``, bit for bit."""
    moe = kind.lower().replace("-", "").replace("_", "") == "megatronmoe"
    cfg = gpt2.GPT2Config(**SMALL)
    model = MoEGPT2(cfg, num_experts=4, drop_tokens=False) if moe else gpt2.GPT2Model(cfg)
    weights = model.init_params(torch.Generator().manual_seed(8)).state_dict()
    write_megatron(weights, SMALL["n_layer"], SMALL["n_head"], str(tmp_path), tp=2, moe=moe)
    with pytest.raises(ValueError, match="n_head"):
        deepspeed_tpu_torch.init_inference(
            config={**SERVE, "checkpoint": str(tmp_path), "checkpoint_config": {"type": kind}},
            device="cpu")
    served = deepspeed_tpu_torch.init_inference(
        config={**SERVE, "checkpoint": str(tmp_path),
                "checkpoint_config": {"type": kind, "n_head": SMALL["n_head"]}}, device="cpu")
    assert type(served.module) is type(model)
    if moe:     # the dense MLP of a MoE block is in no file, and never used
        weights.update({k: torch.zeros_like(v) for k, v in weights.items()
                        if k.startswith("blocks.1.fc")})
    direct = deepspeed_tpu_torch.init_inference(model, SERVE, params=weights, device="cpu")
    ids = _prompt()
    with torch.no_grad():
        assert torch.equal(served(ids), direct(ids))


def test_model_none_raises_without_a_megatron_checkpoint(tags):
    with pytest.raises(ValueError, match="needs a model"):
        deepspeed_tpu_torch.init_inference(config={**SERVE,
                                                   "checkpoint": str(tags["root"] / "zero0")},
                                           device="cpu")


def test_params_take_precedence_over_checkpoint(tmp_path):
    weights = _init_weights()
    served = deepspeed_tpu_torch.init_inference(
        gpt2.GPT2Model(gpt2.GPT2Config(**SMALL)),
        {**SERVE, "checkpoint": str(tmp_path / "nothing_here")}, params=weights, device="cpu")
    assert all(torch.equal(p, weights[n]) for n, p in served.module.named_parameters())


@pytest.mark.parametrize("source", ["zero3_two_ranks", "infinity"])
def test_tags_of_every_placement_serve_stage0s_logits(tags, source):
    root = tags["root"]
    path = root / "zero3" / "tag" if source == "zero3_two_ranks" else root / "infinity"
    ids = _prompt()
    ref = _serve(str(root / "zero0"))(ids)
    got = _serve(str(path))(ids)
    assert tuple(got.shape) == (2, 12, SMALL["vocab_size"])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=LOGIT_RTOL * ref.abs().max().item())
    if source == "infinity":
        want = tags["infinity"].flat_state()
        served = _serve(str(path)).module.state_dict()
        for name, p in served.items():
            assert torch.equal(p, want[f"params/{name}"]), name
