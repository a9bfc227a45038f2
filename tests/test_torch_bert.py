"""The port's BERT masked-LM path against the JAX package, on the CPU.

``params_from_jax`` copies the JAX package's BERT params exactly; the same
numpy batch (``synthetic_mlm_batch`` draws the JAX package's ids and
labels) goes into both. Logits with ``token_type_ids`` and an
``attention_mask``, the MLM loss and every gradient are held to the JAX
``BertModel`` (under ``jax.grad``), with the full head and the gathered
head of ``max_predictions_per_seq`` (rows over the cap included), in fp32
at the tolerances of ``test_torch_gpt2.py``: loss rtol 1e-5, gradients
rtol 1e-4 / atol 2e-5. The gathered positions are the JAX ``top_k``'s (a
stable order: each row's masked positions first, in index order), and
``loss_tokens`` counts what the loss averages over.

Then the engine: one JAX engine run with LAMB (3 steps, gas 2, the even
rows carrying several times the odd rows' labels) is what the port is
held to at 1e-4, in one process and over two spawned gloo ranks at ZeRO
stages 1 and 3, whose label counts differ. A BERT model given to
``init_inference`` serves its logits and refuses ``generate``, as the JAX
engine does; the registry resolves ``bert-*`` and ``gpt2-moe-*`` (MoEGPT2
with 8 experts on the dense preset) and refuses a family not yet ported.
The JAX engine's flat state (what its tag holds) continues in the port
through ``state_from_jax``, and a tag the port trains serves bit for bit.

The ranks import no JAX: this module imports it inside its functions.
"""

import logging

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import flatten_state
from tests.torch_world import World

SMALL = dict(vocab_size=256, n_positions=32, n_embd=64, n_layer=2, n_head=4,
             intermediate_size=128)
B, T, WORLD, STEPS, GAS = 4, 32, 2, 3, 2
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
THRESHOLD = 1000
CASES = {"full": dict(), "full_masked_types": dict(types=True, attn=True),
         "gathered_masked_types": dict(max_predictions_per_seq=8, types=True, attn=True),
         "gathered_over_cap_relu": dict(max_predictions_per_seq=3, activation="relu"),
         "gathered_gelu_new_remat": dict(max_predictions_per_seq=8, activation="gelu_new",
                                         remat="full")}
STAGES = (1, 3)


def _tcfg(**over):
    return tbert.BertConfig(**{**SMALL, **over}, dtype=torch.float32)


def _jcfg(**over):
    import jax.numpy as jnp

    from deepspeed_tpu.models import bert as jbert

    return jbert.BertConfig(**{**SMALL, **over}, dtype=jnp.float32)


def _jax_params(cfg, seed=0):
    import jax

    from deepspeed_tpu.models import bert as jbert

    return jax.tree.map(np.asarray, jbert.BertModel(cfg).init_params(jax.random.PRNGKey(seed)))


def _batch(rows=B, seed=0, types=False, attn=False):
    """The JAX package's synthetic MLM batch (int32 numpy), with optional
    two-segment token types and a key padding mask keeping each row's
    first 20-32 tokens."""
    from deepspeed_tpu.models import bert as jbert

    batch = jbert.synthetic_mlm_batch(rows, T, SMALL["vocab_size"], seed=seed)
    rs = np.random.RandomState(seed)
    if types:
        split = rs.randint(8, T - 8, size=(rows, 1))
        batch["token_type_ids"] = (np.arange(T)[None] >= split).astype(np.int32)
    if attn:
        keep = rs.randint(20, T + 1, size=(rows, 1))
        batch["attention_mask"] = np.arange(T)[None] < keep
    return batch


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_leaf(tree, name):
    if name.startswith("blocks."):
        _, n, key = name.split(".")
        return tree["blocks"][key][int(n)]
    return tree[name]


def _split(over):
    over = dict(over)
    return over.pop("types", False), over.pop("attn", False), over


# --------------------------------------------------------- model vs JAX
def test_params_from_jax_is_exact():
    params = _jax_params(_jcfg())
    model = tbert.params_from_jax(params, _tcfg())
    sd = model.state_dict()
    assert len(sd) == 10 + len(tbert.BLOCK_KEYS) * SMALL["n_layer"]
    for name, t in sd.items():
        assert np.array_equal(t.numpy(), _jax_leaf(params, name)), name
    fresh = tbert.BertModel(_tcfg())
    assert {n: p.shape for n, p in fresh.named_parameters()} == {n: t.shape for n, t in sd.items()}


@pytest.mark.parametrize("types,attn", [(False, False), (True, True)])
def test_logits_match_jax(types, attn):
    import jax.numpy as jnp

    from deepspeed_tpu.models import bert as jbert

    params = _jax_params(_jcfg(), seed=1)
    batch = _batch(seed=1, types=types, attn=attn)
    kw = {k: batch[k] for k in ("token_type_ids", "attention_mask") if k in batch}
    ref = jbert.BertModel(_jcfg()).apply(params, jnp.asarray(batch["input_ids"]),
                                         **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = tbert.params_from_jax(params, _tcfg()).apply(
            torch.from_numpy(batch["input_ids"]), **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_mlm_loss_and_grads_match_jax(case):
    import jax

    from deepspeed_tpu.models import bert as jbert

    types, attn, over = _split(CASES[case])
    jover = {k: v for k, v in over.items() if k != "remat"}
    params = _jax_params(_jcfg(**jover), seed=2)
    batch = _batch(seed=2, types=types, attn=attn)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jbert.BertModel(_jcfg(**jover)).loss(p, batch)))(params)
    model = tbert.params_from_jax(params, _tcfg(**over))
    loss = model.loss(_torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss), **LOSS_TOL)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(_jax_leaf(jgrads, name)),
                                   err_msg=name, **GRAD_TOL)


def test_over_cap_case_has_rows_over_the_cap():
    labels = _batch(seed=2)["labels"]
    assert ((labels != tbert.IGNORE_INDEX).sum(axis=1) > 3).any()


def test_gathered_positions_are_the_jax_top_k():
    """Rows with ties, rows under the cap and an empty row: the first
    ``maxp`` masked positions in index order, then the first unmasked
    ones, with their weights."""
    import jax
    import jax.numpy as jnp

    rs = np.random.RandomState(3)
    mask = rs.rand(6, T) < np.array([0.05, 0.2, 0.5, 0.9, 0.0, 1.0])[:, None]
    for maxp in (1, 4, 8, 31):
        w, pos = jax.lax.top_k(jnp.asarray(mask.astype(np.int32)), maxp)
        got_pos, got_w = tbert.gathered_positions(torch.from_numpy(mask), maxp)
        np.testing.assert_array_equal(got_pos.numpy(), np.asarray(pos))
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(w).astype(bool))


def test_gathered_loss_equals_the_full_loss_under_the_cap():
    params = _jax_params(_jcfg(), seed=4)
    batch = _torch(_batch(seed=4))
    most = int((batch["labels"] != tbert.IGNORE_INDEX).sum(dim=1).max())
    full = tbert.params_from_jax(params, _tcfg()).loss(batch)
    capped = tbert.params_from_jax(params, _tcfg(max_predictions_per_seq=most)).loss(batch)
    torch.testing.assert_close(capped, full, rtol=1e-6, atol=0)


@pytest.mark.parametrize("maxp", [None, 3, 8])
def test_loss_tokens_count_the_labels_the_loss_averages(maxp):
    batch = _torch(_batch(seed=5))
    labels = batch["labels"]
    counts = (labels != tbert.IGNORE_INDEX).sum(dim=1)
    want = counts.sum() if maxp is None else counts.clamp(max=maxp).sum()
    got = tbert.BertModel(_tcfg(max_predictions_per_seq=maxp)).loss_tokens(batch)
    assert got.dtype == torch.float32 and got.item() == want.item()
    if maxp is not None:
        assert int(tbert.gathered_positions(labels != tbert.IGNORE_INDEX, maxp)[1].sum()) == \
            want.item()


def test_debug_mlm_warns_once_for_rows_over_the_cap(monkeypatch, caplog):
    monkeypatch.setenv("DS_DEBUG_MLM", "1")
    monkeypatch.setattr(tbert, "_mlm_overflow_warned", False)
    model = tbert.BertModel(_tcfg(max_predictions_per_seq=3)).init_params(
        torch.Generator().manual_seed(0))
    monkeypatch.setattr(tbert.logger, "propagate", True)
    with caplog.at_level(logging.WARNING):
        model.loss(_torch(_batch(seed=2)))
        model.loss(_torch(_batch(seed=2)))
    assert sum("max_predictions_per_seq=3" in r.message for r in caplog.records) == 1


def test_synthetic_mlm_batch_draws_the_jax_batch():
    from deepspeed_tpu.models import bert as jbert

    for maxp in (None, 4):
        ref = jbert.synthetic_mlm_batch(3, T, 100, seed=7, max_predictions=maxp)
        got = tbert.synthetic_mlm_batch(3, T, 100, seed=7, max_predictions=maxp)
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == torch.int64 and np.array_equal(got[k].numpy(), ref[k])


def test_param_chunks_and_init_params():
    cfg = _tcfg()
    model = tbert.BertModel(cfg)
    shapes = {n: p.shape for n, p in model.named_parameters()}
    seen = {}
    for name, start, values in model.param_chunks(torch.Generator().manual_seed(1), chunk=500):
        assert start == seen.get(name, 0)
        seen[name] = start + values.numel()
    assert seen == {n: s.numel() for n, s in shapes.items()}
    sd = tbert.BertModel(cfg).init_params(torch.Generator().manual_seed(1)).state_dict()
    for name, w in sd.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("_g"):
            assert torch.equal(w, torch.ones_like(w)), name
        elif leaf.endswith("_b"):
            assert torch.equal(w, torch.zeros_like(w)), name
        else:
            assert abs(w.std().item() - 0.02) < 0.002, name


def test_num_params_and_flops_match_jax():
    from deepspeed_tpu.models import bert as jbert

    for name in ("bert-tiny", "bert-large"):
        c, j = tbert.PRESETS[name], jbert.PRESETS[name]
        assert c.num_params() == j.num_params()
        for maxp in (None, 20, 80):
            cm = tbert.BertConfig(**{**c.__dict__, "max_predictions_per_seq": maxp})
            jm = jbert.BertConfig(**{**j.__dict__, "max_predictions_per_seq": maxp})
            assert cm.flops_per_token(128) == jm.flops_per_token(128)
    assert _tcfg().num_params() == sum(p.numel() for p in tbert.BertModel(_tcfg()).parameters())


def test_later_knobs_raise():
    """``flash_block`` (the TPU kernel's tile) is accepted and changes
    nothing, as in port GPT-2; the "dots" and "attn" remat policies are
    carried and "attn_mlp" is refused, as in JAX; ``pld_theta`` without a
    generator runs every block (JAX without an rng)."""
    assert _tcfg(flash_block=64).flash_block == 64
    assert _tcfg(remat="dots").remat == "dots" and _tcfg(remat="attn").remat == "attn"
    for bad in ({"activation": "quick_gelu"}, {"remat": "attn_mlp"}):
        with pytest.raises(ValueError):
            _tcfg(**bad)
    model = tbert.BertModel(_tcfg()).init_params(torch.Generator().manual_seed(0))
    batch = _torch(_batch())
    assert torch.equal(model.loss(batch, pld_theta=0.5), model.loss(batch))
    assert _tcfg(scan_unroll=4).scan_unroll == 4


def test_registry_resolves_bert_and_refuses_gpt2_moe():
    from deepspeed_tpu_torch.models.registry import resolve_family

    cls, presets = resolve_family("bert-large")
    assert cls is tbert.BertModel and presets is tbert.PRESETS
    c = presets["bert-large"]
    assert (c.n_embd, c.n_layer, c.n_head, c.head_dim, c.layer_norm_eps) == \
        (1024, 24, 16, 64, 1e-12)
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.models.gpt2_moe import MoEGPT2

    moe_cls, moe_presets = resolve_family("gpt2-moe-125m")
    assert moe_cls.func is MoEGPT2 and moe_cls.keywords == {"num_experts": 8, "ep_size": 1}
    assert moe_presets == {"gpt2-moe-125m": gpt2.PRESETS["gpt2-125m"]}
    with pytest.raises(NotImplementedError, match="later slice"):
        resolve_family("clip-vit-b16")
    with pytest.raises(KeyError):
        resolve_family("bert-huge")


def test_init_inference_serves_logits_and_refuses_generate_like_jax():
    import deepspeed_tpu
    from deepspeed_tpu.models import bert as jbert

    ids = _batch(seed=6)["input_ids"][:2, :8]
    jeng = deepspeed_tpu.init_inference(jbert.BertModel(jbert.PRESETS["bert-tiny"]),
                                        config={"dtype": "fp32"})
    teng = deepspeed_tpu_torch.init_inference(tbert.BertModel(tbert.PRESETS["bert-tiny"]),
                                              config={"dtype": "float32"}, device="cpu")
    assert jeng(ids).shape == tuple(teng(ids).shape) == (2, 8, 1024)
    for eng in (jeng, teng):
        with pytest.raises(AttributeError, match="init_cache"):
            eng.generate(ids, max_new_tokens=2)


# ------------------------------------------------------------------ engine
def _engine_batch():
    """Global rows whose even rows (rank 0's) carry several times the
    labels of the odd rows (rank 1's), with token types."""
    rs = np.random.RandomState(8)
    rows = 8 * GAS
    ids = rs.randint(4, SMALL["vocab_size"], size=(rows, T)).astype(np.int32)
    frac = np.where(np.arange(rows)[:, None] % 2 == 0, 0.4, 0.02)
    predict = rs.rand(rows, T) < frac
    predict[:, 0] = True                     # every row has a label
    return {"input_ids": np.where(predict, 0, ids).astype(np.int32),
            "labels": np.where(predict, ids, tbert.IGNORE_INDEX).astype(np.int32),
            "token_type_ids": (np.arange(T)[None] >= T // 2).repeat(rows, 0).astype(np.int32)}


def _config(stage):
    return {"train_batch_size": 8 * GAS, "gradient_accumulation_steps": GAS,
            "steps_per_print": 0, "gradient_clipping": 1.0,
            "optimizer": {"type": "Lamb", "params": {"lr": 2e-3, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage,
                                  "stage3_param_persistence_threshold": THRESHOLD}}


ENGINE_CFG = dict(max_predictions_per_seq=12)


def _port_run(np_params, config, batch):
    model = tbert.params_from_jax(np_params, _tcfg(**ENGINE_CFG))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu")
    losses = [float(engine.train_batch(batch)) for _ in range(STEPS)]
    return {"losses": losses, "grad_norm": engine.get_global_grad_norm(),
            "params": {k[len("params/"):]: v.numpy().copy()
                       for k, v in flatten_state(engine).items() if k.startswith("params/")}}


def _ranks(rank, world, out_dir, np_params):
    batch = {k: v[rank::WORLD] for k, v in _engine_batch().items()}
    return {stage: _port_run(np_params, _config(stage), batch) for stage in STAGES}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    import deepspeed_tpu
    from deepspeed_tpu.models import bert as jbert
    from deepspeed_tpu.runtime.checkpoint_engine.engine import _flatten_state

    params = _jax_params(_jcfg(**ENGINE_CFG), seed=9)
    world = World(_ranks, WORLD, str(tmp_path_factory.mktemp("bert_zero")), args=(params,))
    eng, *_ = deepspeed_tpu.initialize(model=jbert.BertModel(_jcfg(**ENGINE_CFG)),
                                       model_parameters=params, config=_config(1))
    batch = _engine_batch()
    ref = {"losses": [float(eng.train_batch(batch)) for _ in range(STEPS)],
           "grad_norm": eng.get_global_grad_norm(),
           "params": jax.tree.map(np.asarray, eng.state.params),
           "flat": {k: np.asarray(v) for k, v in _flatten_state(eng.state).items()}}
    ref["continued"] = [float(eng.train_batch(batch)) for _ in range(2)]
    return {"params": params, "jax": ref, "ranks": world.join()}


def _assert_like_jax(got, ref, what):
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4, err_msg=what)
    assert got["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-4), what
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, _jax_leaf(ref["params"], name), rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what} {name}")


def test_label_counts_differ_between_the_ranks():
    labels = _engine_batch()["labels"] != tbert.IGNORE_INDEX
    for mb in (slice(0, 8), slice(8, 16)):
        counts = [np.minimum(labels[mb][r::WORLD].sum(axis=1), 12).sum() for r in range(WORLD)]
        assert counts[0] > 2 * counts[1]


def test_initialize_with_lamb_trains_like_the_jax_engine(runs):
    got = _port_run(runs["params"], _config(0), _engine_batch())
    _assert_like_jax(got, runs["jax"], "one process")
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("stage", STAGES)
def test_two_ranks_with_unequal_label_counts_train_like_the_jax_engine(runs, stage):
    for rank, got in enumerate(runs["ranks"]):
        _assert_like_jax(got[stage], runs["jax"], f"rank {rank} stage {stage}")


def test_jax_bert_state_continues_in_the_port(runs):
    """The JAX engine's flat state after its steps (``_flatten_state``,
    what a tag's ``state/`` holds: LAMB's moments and the layer-stacked
    ``blocks/<key>`` leaves) carried by ``state_from_jax`` into a port
    engine built from other weights: it continues with the JAX engine's
    losses."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (apply_flat_state,
                                                                       state_from_jax)

    model = tbert.params_from_jax(_jax_params(_jcfg(**ENGINE_CFG), seed=12),
                                  _tcfg(**ENGINE_CFG))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=_config(1), device="cpu")
    state = state_from_jax(runs["jax"]["flat"])
    assert set(state) == set(flatten_state(engine))
    assert {k for k in state if k.startswith("opt_state/mu/blocks.1.")} == \
        {f"opt_state/mu/blocks.1.{key}" for key in tbert.BLOCK_KEYS}
    apply_flat_state(engine, state)
    assert engine.global_steps == STEPS
    losses = [float(engine.train_batch(_engine_batch())) for _ in range(2)]
    np.testing.assert_allclose(losses, runs["jax"]["continued"], rtol=1e-4)


def test_a_trained_bert_tag_is_served_bit_for_bit(tmp_path):
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import wait_for_pending_saves

    model = tbert.BertModel(_tcfg()).init_params(torch.Generator().manual_seed(13))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config={**_config(0), "train_batch_size": 4,
                             "gradient_accumulation_steps": 1}, device="cpu")
    engine.train_batch(_batch(seed=13))
    engine.save_checkpoint(str(tmp_path))
    wait_for_pending_saves()
    served = deepspeed_tpu_torch.init_inference(
        tbert.BertModel(_tcfg()), config={"checkpoint": str(tmp_path), "dtype": "float32"},
        device="cpu")
    got, want = served.module.state_dict(), engine.module_state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[n], want[n]) for n in got)


def test_a_bert_batch_reaches_the_device_whole():
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=tbert.BertModel(_tcfg()), config={**_config(0), "train_batch_size": 4,
                                                "gradient_accumulation_steps": 1},
        device="cpu")
    batch = _batch(seed=10, types=True, attn=True)
    got = engine._to_device(batch)
    assert got.keys() == batch.keys()
    for k, v in got.items():
        assert v.dtype == torch.int64 and v.device == engine.device
        assert np.array_equal(v.numpy(), batch[k].astype(np.int64)), k
    assert float(engine.train_batch(batch)) > 0


def test_fp16_overflow_steps_skip():
    """fp16 with a loss scale so large that the scaled gradients overflow:
    the engine skips the steps, keeps the params, advances the step
    counter and halves the scale each time (hysteresis 1), the JAX
    engine's rule that ``test_torch_train.py`` holds the port to."""
    cfg = {"train_batch_size": 8, "steps_per_print": 0,
           "fp16": {"enabled": True, "initial_scale_power": 60, "hysteresis": 1},
           "optimizer": {"type": "Lamb", "params": {"lr": 1e-3}}}
    params = _jax_params(_jcfg(), seed=11)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=tbert.params_from_jax(params, tbert.BertConfig(**SMALL, dtype=torch.float16)),
        config=cfg, device="cpu")
    before = {k: v.detach().clone() for k, v in engine.module.state_dict().items()}
    for _ in range(2):
        engine.train_batch(_batch(8, seed=11))
    assert (engine.skipped_steps, engine.global_steps, engine.get_loss_scale()) == \
        (2, 2, 2.0 ** 58)
    for k, v in engine.module.state_dict().items():
        assert torch.equal(v, before[k]), k
