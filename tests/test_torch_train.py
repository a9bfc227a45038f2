"""The port's training stack against the JAX package: optimizers, lr
schedules, the loss scaler, the config's batch triple, and the engine.

Everything runs in fp32 on the CPU with the same numpy inputs on both sides.
Optimizer and engine results differ only in rounding order (JAX evaluates
the bias corrections and schedules in fp32, the port in Python floats):
params rtol 1e-5 after three optimizer steps, schedules rtol 1e-6, and the
engine's losses and final params within 1e-4 after three steps of a small
GPT-2. The JAX engine runs on the test conftest's 8-device CPU mesh (data
parallel over 8); the port on one device, with the same global batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tls

SHAPES = [(16, 8), (8,), (3, 4, 5)]


# ------------------------------------------------------------- optimizers
@pytest.mark.parametrize("name,params", [
    ("adamw", {"lr": 1e-2, "weight_decay": 0.01}),
    ("adam", {"lr": 1e-2, "weight_decay": 0.01, "adam_w_mode": False, "betas": [0.8, 0.99]}),
    ("lamb", {"lr": 1e-2, "weight_decay": 0.01}),
    ("lion", {"lr": 1e-3, "weight_decay": 0.01}),
    ("adagrad", {"lr": 1e-2, "weight_decay": 0.01}),
    ("sgd", {"lr": 1e-2, "momentum": 0.9, "nesterov": True, "weight_decay": 0.01}),
])
def test_optimizer_matches_jax(name, params):
    rs = np.random.RandomState(0)
    p0 = [rs.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rs.standard_normal(s).astype(np.float32) for s in SHAPES] for _ in range(3)]

    jo = jopt.build_optimizer(name, params)
    jp = [jnp.asarray(p) for p in p0]
    jstate = jo.init(jp)
    to = topt.build_optimizer(name, params)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    tstate = to.init(tp)
    for g in grads:
        updates, jstate = jo.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tstate = to.update([torch.from_numpy(x) for x in g], tstate, tp, lr=params["lr"])
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_unknown_optimizer_raises_like_jax():
    with pytest.raises(ValueError):
        jopt.build_optimizer("adamax", {})
    with pytest.raises(ValueError):
        topt.build_optimizer("adamax", {})


# ---------------------------------------------------------- lr schedules
@pytest.mark.parametrize("name,params", [
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3, "warmup_num_steps": 10}),
    ("WarmupLR", {"warmup_max_lr": 2e-3, "warmup_num_steps": 8, "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 30, "warmup_max_lr": 1e-3, "warmup_num_steps": 10}),
    ("WarmupCosineLR", {"total_num_steps": 30, "warmup_num_steps": 5, "warmup_min_ratio": 0.1,
                        "cos_min_ratio": 0.01, "warmup_max_lr": 3e-4}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 4,
                     "lr_range_test_step_rate": 0.5}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 4,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3, "cycle_first_step_size": 5,
                  "cycle_second_step_size": 7, "decay_lr_rate": 0.1, "decay_step_size": 2}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3, "cycle_first_step_size": 5}),
])
def test_lr_schedule_matches_jax(name, params):
    js = jlr.build_lr_schedule(name, params)
    ts = tlr.build_lr_schedule(name, params)
    steps = [0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 15, 19, 25, 29, 30, 31, 50]
    np.testing.assert_allclose([ts.lr_at(s) for s in steps],
                               [float(js.lr_at(s)) for s in steps], rtol=1e-6, atol=1e-12)
    for _ in range(3):
        js.step()
        ts.step()
    np.testing.assert_allclose(ts.get_lr(), js.get_lr(), rtol=1e-6)


# ------------------------------------------------------------ loss scaler
FLAGS = [True, True, True, False, True, False, False, True, True, True, True, False,
         False, False, True, True, True, True, True, True, True]


@pytest.mark.parametrize("kw", [
    dict(init_scale=2.0 ** 8, scale_window=3, delayed_shift=1, min_scale=1.0),
    dict(init_scale=2.0 ** 4, scale_window=4, delayed_shift=2, min_scale=2.0),
    dict(init_scale=2.0 ** 6, scale_window=2, delayed_shift=2, consecutive_hysteresis=True),
])
def test_dynamic_loss_scaler_matches_jax(kw):
    js, ts = jls.DynamicLossScaler(**kw), tls.DynamicLossScaler(**kw)
    jstate, tstate = js.initial_state(), ts.initial_state()
    for finite in FLAGS:
        jstate = js.update(jstate, jnp.bool_(finite))
        tstate = ts.update(tstate, finite)
        assert (tstate.scale, tstate.good_steps, tstate.hysteresis, tstate.overflows) == (
            float(jstate.scale), int(jstate.good_steps), int(jstate.hysteresis),
            int(jstate.overflows))


def test_create_loss_scaler_and_grads_finite_match_jax():
    for args in [(16, 0.0, True), (16, 128.0, False), (32, 0.0, True)]:
        jdt, tdt = {16: (jnp.float16, torch.float16), 32: (jnp.float32, torch.float32)}[args[0]]
        j = jls.CreateLossScaler(jdt, args[1], args[2], {"init_scale": 2.0 ** 5})
        t = tls.CreateLossScaler(tdt, args[1], args[2], {"init_scale": 2.0 ** 5})
        assert type(j).__name__ == type(t).__name__
        assert float(j.initial_state().scale) == t.initial_state().scale
    g = [np.ones(3, np.float32), np.array([1.0, np.inf], np.float32)]
    assert bool(jls.grads_finite([jnp.asarray(x) for x in g])) is False
    assert bool(tls.grads_finite([torch.from_numpy(x) for x in g])) is False
    assert bool(tls.grads_finite([torch.from_numpy(g[0])])) is True


@pytest.mark.parametrize("norm_type", [2.0, 1.0, np.inf])
def test_grad_norm_and_clip_match_jax(norm_type):
    from deepspeed_tpu.runtime import utils as jutils
    from deepspeed_tpu_torch.runtime import utils as tutils

    rs = np.random.RandomState(6)
    g = [rs.standard_normal(s).astype(np.float32) for s in SHAPES]
    jg, jn = jutils.clip_grad_norm_([jnp.asarray(x) for x in g], 0.5, norm_type)
    tg, tn = tutils.clip_grad_norm_([torch.from_numpy(x.copy()) for x in g], 0.5, norm_type)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
    np.testing.assert_allclose(float(tutils.get_grad_norm([torch.from_numpy(x) for x in g],
                                                          norm_type)), float(jn), rtol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


# -------------------------------------------------------------- config
@pytest.mark.parametrize("cfg,ws", [
    ({"train_batch_size": 32}, 4),
    ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 2}, 4),
    ({"train_batch_size": 32, "gradient_accumulation_steps": 2}, 4),
    ({"train_micro_batch_size_per_gpu": 3, "gradient_accumulation_steps": 2}, 2),
    ({"train_micro_batch_size_per_chip": 3}, 1),
    ({"train_batch_size": 24, "train_micro_batch_size_per_gpu": 3,
      "gradient_accumulation_steps": 2}, 4),
    ({"train_batch_size": 24, "train_micro_batch_size_per_gpu": 3,
      "gradient_accumulation_steps": 2}, 2),                     # mismatch
    ({"train_batch_size": 30, "train_micro_batch_size_per_gpu": 4}, 2),   # not divisible
    ({"train_batch_size": 30, "gradient_accumulation_steps": 4}, 2),
    ({"train_batch_size": 3}, 4),
    ({"gradient_accumulation_steps": 2}, 1),                     # neither size given
])
def test_batch_triple_matches_jax(cfg, ws):
    def resolve(cls):
        try:
            c = cls(dict(cfg), world_size=ws)
        except ValueError as e:
            return "ValueError", str(e)
        return (c.train_batch_size, c.train_micro_batch_size_per_gpu,
                c.gradient_accumulation_steps)

    assert resolve(TConfig) == resolve(JConfig)


def test_config_blocks_parse_like_jax_and_later_blocks_raise():
    cfg = {"train_batch_size": 8, "fp16": {"enabled": True, "loss_scale_window": 50,
                                           "hysteresis": 3},
           "zero_optimization": {"stage": 2, "stage3_prefetch_bucket_size": 1000},
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-4}},
           "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 5}},
           "gradient_clipping": 0.5, "data_types": {"grad_accum_dtype": "bf16"},
           "steps_per_print": 7}
    j, t = JConfig(cfg, world_size=1), TConfig(cfg, world_size=1)
    for attr in ("optimizer_name", "optimizer_params", "scheduler_name", "scheduler_params",
                 "gradient_clipping", "steps_per_print", "seed", "zero_optimization_stage"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert (t.fp16.loss_scale_window, t.fp16.hysteresis) == (50, 3)
    assert t.zero_config.prefetch_bucket_size == j.zero_config.prefetch_bucket_size == 1000
    assert t.train_dtype == torch.float16 and t.grad_accum_dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="telemetry"):
        TConfig({"train_batch_size": 8, "telemetry": {"enabled": True}})
    with pytest.raises(NotImplementedError):
        TConfig({"train_batch_size": 8, "zero_optimization": {
            "stage": 2, "offload_optimizer": {"device": "cpu"}}})
    with pytest.raises(ValueError, match="gradient_clipping"):
        TConfig({"train_batch_size": 8, "gradient_cliping": 1.0})
    with pytest.raises(ValueError, match="did you mean"):
        TConfig({"train_batch_size": 8, "zero_optimization": {"stag": 1}})


# -------------------------------------------------------------- engine
SMALL = dict(vocab_size=512, n_positions=64, n_embd=128, n_layer=2, n_head=2, remat=False)


def _engines(cfg, dtype=("float32",)):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "float16": (jnp.float16, torch.float16)}[dtype[0]]
    jcfg = jgpt2.GPT2Config(**SMALL, dtype=jdt)
    params = jgpt2.GPT2Model(jcfg).init_params(jax.random.PRNGKey(0))
    jeng, *_ = deepspeed_tpu.initialize(model=jgpt2.GPT2Model(jcfg), model_parameters=params,
                                        config=dict(cfg))
    tmodel = tgpt2.params_from_jax(jax.tree.map(np.asarray, params),
                                   tgpt2.GPT2Config(**SMALL, dtype=tdt))
    teng, topt_, loader, sched = deepspeed_tpu_torch.initialize(model=tmodel, config=dict(cfg),
                                                                device="cpu")
    assert loader is None and topt_ is teng.optimizer and sched is teng.lr_scheduler
    return jeng, teng


def _assert_params_match(jeng, teng, **tol):
    jp = jax.tree.map(np.asarray, jeng.state.params)
    for name, p in teng.module.named_parameters():
        if name.startswith("blocks."):
            _, n, key = name.split(".")
            ref = jp["blocks"][key][int(n)]
        else:
            ref = jp[name]
        np.testing.assert_allclose(p.detach().float().numpy(), ref.astype(np.float32),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("gas", [1, 2])
def test_engine_train_batch_matches_jax(gas):
    cfg = {"train_batch_size": 8 * gas, "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-4,
                                                        "warmup_max_lr": 1e-3,
                                                        "warmup_num_steps": 2,
                                                        "warmup_type": "linear"}},
           "gradient_clipping": 1.0, "steps_per_print": 0}
    jeng, teng = _engines(cfg)
    batch = {"input_ids": np.random.RandomState(gas).randint(
        0, SMALL["vocab_size"], size=(8 * gas, 64)).astype(np.int32)}
    jl = [float(jeng.train_batch(batch)) for _ in range(3)]
    tl = [float(teng.train_batch(batch)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    assert teng.global_steps == jeng.global_steps == 3
    assert teng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-6)
    assert teng.get_global_grad_norm() == pytest.approx(jeng.get_global_grad_norm(), rel=1e-4)
    _assert_params_match(jeng, teng, rtol=1e-4, atol=1e-5)


def test_engine_skips_a_non_finite_fp16_step_like_jax():
    """A loss mask holding inf makes every gradient NaN: both engines skip
    the step, keep params, advance the step counter and halve the scale."""
    cfg = {"train_batch_size": 8, "steps_per_print": 0,
           "fp16": {"enabled": True, "initial_scale_power": 4, "hysteresis": 1},
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    jeng, teng = _engines(cfg, dtype=("float16",))
    before = {k: v.detach().clone() for k, v in teng.module.state_dict().items()}
    mask = np.ones((8, 64), np.float32)
    mask[3, 10] = np.inf
    batch = {"input_ids": np.random.RandomState(5).randint(
        0, SMALL["vocab_size"], size=(8, 64)).astype(np.int32), "loss_mask": mask}
    jeng.train_batch(batch)
    teng.train_batch(batch)
    for eng in (jeng, teng):
        assert (eng.skipped_steps, eng.global_steps, eng.get_loss_scale()) == (1, 1, 8.0)
    for k, v in teng.module.state_dict().items():
        assert torch.equal(v, before[k]), k
    _assert_params_match(jeng, teng, rtol=0, atol=0)


def test_engine_three_call_api_matches_train_batch():
    cfg = {"train_batch_size": 8, "gradient_accumulation_steps": 2, "steps_per_print": 0,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    model = lambda: tgpt2.params_from_jax(
        jax.tree.map(np.asarray, jgpt2.GPT2Model(jgpt2.GPT2Config(
            **SMALL, dtype=jnp.float32)).init_params(jax.random.PRNGKey(1))),
        tgpt2.GPT2Config(**SMALL, dtype=torch.float32))
    e1, *_ = deepspeed_tpu_torch.initialize(model=model(), config=dict(cfg), device="cpu")
    e2, *_ = deepspeed_tpu_torch.initialize(model=model(), config=dict(cfg), device="cpu")
    ids = torch.from_numpy(np.random.RandomState(2).randint(0, 512, size=(8, 64)))
    e1.train_batch({"input_ids": ids})
    for i, half in enumerate((ids[:4], ids[4:])):
        e2.backward(e2({"input_ids": half}))
        assert e2.is_gradient_accumulation_boundary() == (i == 1)
        e2.step()
        assert e2.global_steps == i
    assert e2.global_steps == 1
    for (n, a), b in zip(e1.module.named_parameters(), e2.module.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=n)
    assert float(e2.eval_batch({"input_ids": ids})) == pytest.approx(
        float(e1.eval_batch({"input_ids": ids})), rel=1e-5)


def test_engine_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.initialize(model=model, config={
            "train_batch_size": 8, "optimizer": {"type": "Adam", "params": {}}})


def test_deleted_engine_frees_its_state():
    """Nothing of the engine's (masters, optimizer state, grad buffers) is
    kept alive by its hooks on the model's parameters, and the hooks go
    with the engine."""
    import weakref

    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, device="cpu", config={
        "train_batch_size": 2, "optimizer": {"type": "Adam", "params": {}}, "steps_per_print": 0})
    engine.train_batch({"input_ids": torch.zeros(2, 16, dtype=torch.long)})
    ref = weakref.ref(engine)
    del engine
    assert ref() is None
    model.loss({"input_ids": torch.zeros(2, 16, dtype=torch.long)}).backward()
    assert model.wte.grad is not None        # its hooks went with it


# -------------------------------------------------- sparse_attention block
SPARSE_BLOCK = {"mode": "fixed", "block": 16, "num_local_blocks": 2, "num_global_blocks": 1}


def test_engine_with_sparse_attention_matches_jax():
    """The ds_config block reaches both models' configs through initialize,
    and three AdamW steps of the sparse model match the JAX engine's."""
    cfg = {"train_batch_size": 8, "steps_per_print": 0, "gradient_clipping": 1.0,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "sparse_attention": dict(SPARSE_BLOCK)}
    jeng, teng = _engines(cfg)
    assert teng.module.config.sparse_attention == SPARSE_BLOCK
    assert jeng.module.config.sparse_attention == SPARSE_BLOCK
    batch = {"input_ids": np.random.RandomState(11).randint(
        0, SMALL["vocab_size"], size=(8, 64)).astype(np.int32)}
    jl = [float(jeng.train_batch(batch)) for _ in range(3)]
    tl = [float(teng.train_batch(batch)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    assert teng.module._sparse is not None          # the sparse path ran
    # atol 1e-4, a tenth of one AdamW step at lr 1e-3: Adam divides by the
    # root of the second moment, so an entry whose gradient is rounding noise
    # in both packages can step by a sizeable share of lr either way (2 of
    # 65536 entries of blocks.0.fc_w differ by 6.6e-5 with this seed)
    _assert_params_match(jeng, teng, rtol=1e-4, atol=1e-4)


def test_sparse_attention_block_conflicts_raise_like_jax():
    """A model whose own block differs from the ds_config's raises; the same
    block is accepted; a model without the field is left alone."""
    jcfg = jgpt2.GPT2Config(**SMALL, dtype=jnp.float32, sparse_attention={"mode": "dense"})
    tcfg = tgpt2.GPT2Config(**SMALL, dtype=torch.float32, sparse_attention={"mode": "dense"})
    cfg = {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {}},
           "sparse_attention": dict(SPARSE_BLOCK)}
    with pytest.raises(ValueError, match="conflicts"):
        deepspeed_tpu.initialize(model=jgpt2.GPT2Model(jcfg), config=dict(cfg))
    with pytest.raises(ValueError, match="conflicts"):
        deepspeed_tpu_torch.initialize(model=tgpt2.GPT2Model(tcfg), config=dict(cfg),
                                       device="cpu")
    same = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32,
                                            sparse_attention=dict(SPARSE_BLOCK)))
    deepspeed_tpu_torch.initialize(model=same, config=dict(cfg), device="cpu")
    assert same.config.sparse_attention == SPARSE_BLOCK

    class NoField(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(3))
            self.config = object()

        def loss(self, batch):
            return (self.w * batch.float()).sum()

    model = NoField()
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=dict(cfg), device="cpu")
    assert not hasattr(model.config, "sparse_attention")


@pytest.mark.parametrize("block,match", [
    ({"mode": "fixed", "num_local_block": 4}, "did you mean 'num_local_blocks'"),
    ({"mode": "bigbird", "num_random_block": 1}, "did you mean 'num_random_blocks'"),
    ({"blok": 16}, "did you mean 'block'"),
])
def test_sparse_attention_block_typo_gets_a_hint_like_jax(block, match):
    cfg = {"train_batch_size": 8, "sparse_attention": block}
    with pytest.raises(ValueError, match=match):
        JConfig(dict(cfg))
    with pytest.raises(ValueError, match=match):
        TConfig(dict(cfg))
    assert TConfig({"train_batch_size": 8, "sparse_attention": dict(SPARSE_BLOCK)}
                   ).sparse_attention == JConfig({"train_batch_size": 8,
                                                  "sparse_attention": dict(SPARSE_BLOCK)}
                                                 ).sparse_attention
