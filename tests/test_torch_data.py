"""The port's data loader and curriculum data pipeline against the JAX package.

The same numpy inputs go through both packages. The loader, the indexed
dataset, the schedulers, the analyzer and the sampler are host code in
numpy on both sides, so they must agree exactly: the same batches, the same
states, the same bytes on disk. The engines trained through
``initialize(training_data=...)`` agree on their losses to 1e-4, the
tolerance of ``test_engine_train_batch_matches_jax`` (fp32 on the CPU,
rounding order only). The JAX engine runs on the test conftest's 8-device
CPU mesh, the port on one device, with the same global batch.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime import dataloader as jdl
from deepspeed_tpu.runtime.data_pipeline import curriculum_scheduler as jcs
from deepspeed_tpu.runtime.data_pipeline import data_analyzer as jda
from deepspeed_tpu.runtime.data_pipeline import data_sampler as jsamp
from deepspeed_tpu.runtime.data_pipeline import data_sampling as jsampling
from deepspeed_tpu.runtime.data_pipeline import indexed_dataset as jidx
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime import dataloader as tdl
from deepspeed_tpu_torch.runtime.data_pipeline import curriculum_scheduler as tcs
from deepspeed_tpu_torch.runtime.data_pipeline import data_analyzer as tda
from deepspeed_tpu_torch.runtime.data_pipeline import data_sampler as tsamp
from deepspeed_tpu_torch.runtime.data_pipeline import data_sampling as tsampling
from deepspeed_tpu_torch.runtime.data_pipeline import indexed_dataset as tidx


def _samples(n, T=8, seed=0):
    rng = np.random.RandomState(seed)
    return [{"input_ids": rng.randint(0, 100, size=T).astype(np.int32), "idx": np.int64(i)}
            for i in range(n)]


def _assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _loaders(n, **kw):
    data = _samples(n)
    return jdl.DeepSpeedDataLoader(data, **kw), tdl.DeepSpeedDataLoader(data, **kw)


# ------------------------------------------------------------ the loader
@pytest.mark.parametrize("n,bs", [(24, 4), (21, 4)])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_three_epochs_match_jax(shuffle, drop_last, n, bs):
    """Three passes through RepeatingLoader: the same batches, the same
    state after every batch (a dataset of 21 does not divide by 4)."""
    jl, tl = _loaders(n, batch_size=bs, shuffle=shuffle, drop_last=drop_last, seed=3)
    assert len(jl) == len(tl)
    jr, tr = jdl.RepeatingLoader(jl), tdl.RepeatingLoader(tl)
    for _ in range(3 * len(jl)):
        _assert_batches_equal(next(jr), next(tr))
        assert tr.state_dict() == jr.state_dict()


@pytest.mark.parametrize("at", ["mid_epoch", "epoch_boundary"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_resumes_like_jax(shuffle, at):
    """A fresh loader of each package, given a state captured mid-epoch or
    exactly at the end of a pass, continues with the same batches."""
    n, bs = 24, 4
    jl, tl = _loaders(n, batch_size=bs, shuffle=shuffle, seed=1)
    jr, tr = jdl.RepeatingLoader(jl), tdl.RepeatingLoader(tl)
    steps = 3 if at == "mid_epoch" else n // bs
    for _ in range(steps):
        next(jr), next(tr)
    sd = tr.state_dict()
    assert sd == jr.state_dict()
    expect = [next(jr) for _ in range(8)]
    j2, t2 = _loaders(n, batch_size=bs, shuffle=shuffle, seed=1)
    j2, t2 = jdl.RepeatingLoader(j2), tdl.RepeatingLoader(t2)
    j2.load_state_dict(dict(sd))
    t2.load_state_dict(dict(sd))
    for want in expect:
        _assert_batches_equal(want, next(t2))
        _assert_batches_equal(want, next(j2))
        assert t2.state_dict() == j2.state_dict()


@pytest.mark.parametrize("new_bs,drop_last", [(6, True), (3, True), (6, False)])
def test_loader_repartitions_like_jax(new_bs, drop_last):
    """A position captured at batch size 4 resumes at another batch size
    with repartition=True at the first sample not consumed."""
    jl, tl = _loaders(26, batch_size=4, shuffle=True, seed=5, drop_last=drop_last)
    it = iter(tl)
    for _ in range(3):
        next(it)
    sd = tl.state_dict()
    j2, t2 = _loaders(26, batch_size=new_bs, shuffle=True, seed=5, drop_last=drop_last)
    j2.load_state_dict(dict(sd), repartition=True)
    t2.load_state_dict(dict(sd), repartition=True)
    assert t2.state_dict() == j2.state_dict()
    jb, tb = list(j2), list(t2)
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        _assert_batches_equal(a, b)
    assert int(tb[0]["idx"][0]) == int(np.random.default_rng(5).permutation(26)[12])


@pytest.mark.parametrize("change", [
    {"batch_size": 8}, {"seed": 9}, {"shuffle": False}, {"drop_last": False},
    {"dataset_size": 99}, {"sampler_driven": True}])
def test_loader_state_mismatches_raise_like_jax(change):
    jl, tl = _loaders(24, batch_size=4, seed=1)
    next(iter(tl))
    sd = {**tl.state_dict(), **change}
    with pytest.raises(ValueError) as jerr:
        jl.load_state_dict(dict(sd))
    with pytest.raises(ValueError) as terr:
        tl.load_state_dict(dict(sd))
    assert str(terr.value) == str(jerr.value)


def test_default_collate_matches_jax():
    samples = [{"a": np.arange(3) + i, "b": (np.float32(i), np.ones(2) * i)} for i in range(4)]
    j, t = jdl._default_collate(samples), tdl._default_collate(samples)
    np.testing.assert_array_equal(j["a"], t["a"])
    for x, y in zip(j["b"], t["b"]):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------- indexed dataset
@pytest.mark.parametrize("code", sorted(tidx._DTYPES))
def test_indexed_dataset_files_are_byte_identical_both_ways(tmp_path, code):
    assert tidx._MAGIC == jidx._MAGIC
    assert {k: np.dtype(v) for k, v in tidx._DTYPES.items()} == \
        {k: np.dtype(v) for k, v in jidx._DTYPES.items()}
    dtype = tidx._DTYPES[code]
    rng = np.random.RandomState(code)
    rows = [(rng.rand(rng.randint(0, 9)) * 100).astype(dtype) for _ in range(7)]
    prefixes = {}
    for name, mod in (("jax", jidx), ("torch", tidx)):
        b = mod.MMapIndexedDatasetBuilder(str(tmp_path / name), dtype=dtype)
        for r in rows:
            b.add_item(r)
        b.finalize()
        prefixes[name] = str(tmp_path / name)
    for ext in (".bin", ".idx"):
        assert (tmp_path / f"jax{ext}").read_bytes() == (tmp_path / f"torch{ext}").read_bytes()
    # each package reads the other's files
    for reader, writer in ((tidx, "jax"), (jidx, "torch")):
        ds = reader.MMapIndexedDataset(prefixes[writer])
        assert len(ds) == len(rows) and ds.dtype == np.dtype(dtype)
        for got, want in zip(ds[0:len(rows)], rows):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ds.row_sizes(), [len(r) for r in rows])


def test_find_fit_int_dtype_matches_jax():
    for lo, hi in [(0, 1), (0, 255), (0, 256), (0, 70000), (0, 2 ** 40), (-1, 1),
                   (-200, 100), (-40000, 5), (-2 ** 40, 3)]:
        assert tidx.find_fit_int_dtype(lo, hi) == jidx.find_fit_int_dtype(lo, hi)


# ---------------------------------------------------- curriculum schedule
SCHEDULES = {
    "fixed_linear": {"curriculum_type": "seqlen", "min_difficulty": 8, "max_difficulty": 64,
                     "schedule_type": "fixed_linear",
                     "schedule_config": {"total_curriculum_step": 100, "difficulty_step": 8}},
    "fixed_root": {"min_difficulty": 8, "max_difficulty": 64, "schedule_type": "fixed_root",
                   "schedule_config": {"total_curriculum_step": 100, "difficulty_step": 8,
                                       "root_degree": 2}},
    "fixed_discrete": {"min_difficulty": 2, "max_difficulty": 6,
                       "schedule_type": "fixed_discrete",
                       "schedule_config": {"difficulty": [2, 4, 6], "max_step": [5, 10]}},
    "custom": {"min_difficulty": 1, "max_difficulty": 10, "schedule_type": "custom"},
}


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_curriculum_scheduler_matches_jax(kind):
    j = jcs.CurriculumScheduler(copy.deepcopy(SCHEDULES[kind]))
    t = tcs.CurriculumScheduler(copy.deepcopy(SCHEDULES[kind]))
    if kind == "custom":
        for s in (j, t):
            s.set_custom_get_difficulty(lambda step: min(10, 1 + step // 3))
    for step in range(0, 130):
        assert t.update_difficulty(step) == j.update_difficulty(step), step
        assert t.state_dict() == j.state_dict()
    t2 = tcs.CurriculumScheduler(copy.deepcopy(SCHEDULES[kind]))
    t2.load_state_dict(j.state_dict())
    assert t2.get_current_difficulty() == j.get_current_difficulty()


# ------------------------------------------------------ seqlen truncation
DS_CONFIGS = [
    {"curriculum_learning": {"enabled": True, "curriculum_type": "seqlen", "min_difficulty": 8,
                             "max_difficulty": 32, "schedule_type": "fixed_linear",
                             "schedule_config": {"total_curriculum_step": 4,
                                                 "difficulty_step": 8}}},
    {"curriculum_learning": {"enabled": False, "min_difficulty": 8}},
    {"data_efficiency": {"data_sampling": {"curriculum_learning": {
        "enabled": True, "curriculum_metrics": {"seqlen": {
            "min_difficulty": 16, "max_difficulty": 64, "schedule_type": "fixed_root",
            "schedule_config": {"total_curriculum_step": 10, "difficulty_step": 8,
                                "root_degree": 2}}}}}}},
    {"data_efficiency": {"data_sampling": {"curriculum_learning": {
        "enabled": True, "curriculum_metrics": {"seqlen": {
            "index_to_sample_path": "x", "index_to_metric_path": "y",
            "min_difficulty": 25, "max_difficulty": 100, "schedule_type": "fixed_linear",
            "schedule_config": {"total_curriculum_step": 12, "difficulty_step": 25}}}}}}},
    {"data_efficiency": {"data_sampling": {"curriculum_learning": {
        "enabled": True, "curriculum_metrics": {"vocabularyrarity": {
            "min_difficulty": 1, "max_difficulty": 9, "schedule_type": "fixed_linear",
            "schedule_config": {"total_curriculum_step": 4, "difficulty_step": 8}}}}}}},
    {"data_efficiency": {"enabled": False, "data_sampling": {"curriculum_learning": {
        "enabled": True, "min_difficulty": 8, "max_difficulty": 16,
        "schedule_type": "fixed_linear"}}}},
    {"data_efficiency": {"data_sampling": {"curriculum_learning": {
        "enabled": True, "min_difficulty": 8, "max_difficulty": 16,
        "schedule_type": "fixed_discrete"}}}},
    {},
]


@pytest.mark.parametrize("i", range(len(DS_CONFIGS)))
def test_curriculum_config_from_ds_matches_jax(i):
    pd = DS_CONFIGS[i]
    assert tsampling.curriculum_config_from_ds(copy.deepcopy(pd)) == \
        jsampling.curriculum_config_from_ds(copy.deepcopy(pd))


@pytest.mark.parametrize("difficulty", [1, 16, 31, 32, 64])
def test_apply_seqlen_curriculum_matches_jax(difficulty):
    rng = np.random.RandomState(difficulty)
    ids = rng.randint(0, 50, size=(4, 32)).astype(np.int32)
    cases = [
        {"input_ids": ids, "labels": ids + 1, "loss_mask": np.ones((4, 32), np.float32),
         "meta": np.zeros((4,)), "other": np.zeros((4, 32))},
        (ids, ids + 1, np.zeros((4, 7))),      # the 7-wide targets are not a sequence
        [ids, np.zeros(4)],
        ids,
        ids[0],
    ]
    for batch in cases:
        j = jsampling.apply_seqlen_curriculum(batch, difficulty)
        t = tsampling.apply_seqlen_curriculum(batch, difficulty)
        assert type(j) is type(t)
        jl = list(j.values()) if isinstance(j, dict) else (list(j) if isinstance(j, (tuple, list))
                                                          else [j])
        tl = list(t.values()) if isinstance(t, dict) else (list(t) if isinstance(t, (tuple, list))
                                                          else [t])
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(a, b)
    # a torch batch is cut as a tensor
    t = tsampling.apply_seqlen_curriculum({"input_ids": torch.from_numpy(ids)}, difficulty)
    assert torch.is_tensor(t["input_ids"])
    np.testing.assert_array_equal(t["input_ids"].numpy(), ids[:, :difficulty])


# ------------------------------------------------ analyzer and the sampler
def _metric_dataset(n=64, vmax=500):
    rng = np.random.default_rng(0)
    lens = rng.integers(4, 33, size=n)
    return [{"input_ids": rng.integers(0, vmax, size=32).astype(np.int32), "seqlen": int(l)}
            for l in lens]


def _sampler_config(paths, difficulty_type, seed=7):
    lo, hi, step = (8, 32, 4) if difficulty_type == "value" else (25, 100, 25)
    return {"seed": seed, "data_sampling": {"num_epochs": 4, "curriculum_learning": {
        "enabled": True, "curriculum_metrics": {"seqlen": {
            "index_to_sample_path": paths["sample_path"],
            "index_to_metric_path": paths["metric_path"],
            "difficulty_type": difficulty_type, "min_difficulty": lo, "max_difficulty": hi,
            "schedule_type": "fixed_linear",
            "schedule_config": {"total_curriculum_step": 10, "difficulty_step": step}}}}}}


def _assert_sampler_states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("workers", [1, 3])
def test_data_analyzer_writes_jax_files_byte_for_byte(tmp_path, workers):
    data = _metric_dataset()
    for name, mod in (("jax", jda), ("torch", tda)):
        for w in range(workers):
            mod.DataAnalyzer(data, ["seqlen", "first"],
                             [lambda s: s["seqlen"], lambda s: int(s["input_ids"][0]) % 7],
                             save_path=str(tmp_path / name), num_workers=workers,
                             worker_id=w).run_map()
        mod.DataAnalyzer(data, ["seqlen", "first"], [None, None], save_path=str(tmp_path / name),
                         num_workers=workers).run_reduce()
    jfiles = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                    if p.is_file())
    tfiles = sorted(p.relative_to(tmp_path / "torch") for p in (tmp_path / "torch").rglob("*")
                    if p.is_file())
    assert jfiles == tfiles and len(jfiles) == 2 * 2 * (3 + workers)
    for rel in jfiles:
        assert (tmp_path / "jax" / rel).read_bytes() == (tmp_path / "torch" / rel).read_bytes()
    assert tda.metric_paths("a", "m") == jda.metric_paths("a", "m")


@pytest.mark.parametrize("difficulty_type", ["value", "percentile"])
def test_data_sampler_matches_jax_and_resumes(tmp_path, difficulty_type):
    data = _metric_dataset()
    tda.DataAnalyzer(data, ["seqlen"], [lambda s: s["seqlen"]], save_path=str(tmp_path)).run()
    cfg = _sampler_config(tda.metric_paths(str(tmp_path), "seqlen"), difficulty_type)
    j = jsamp.DeepSpeedDataSampler(copy.deepcopy(cfg), len(data), global_batch_size=8)
    t = tsamp.DeepSpeedDataSampler(copy.deepcopy(cfg), len(data), global_batch_size=8)
    assert len(j) == len(t)
    for step in range(12):
        np.testing.assert_array_equal(next(t), next(j), err_msg=str(step))
        _assert_sampler_states_equal(t.state_dict(), j.state_dict())
    sd = t.state_dict()
    expect = [next(j) for _ in range(6)]
    # each package resumes from the port's state and from the JAX one's
    for mod, state in ((tsamp, sd), (jsamp, sd), (tsamp, None)):
        s = mod.DeepSpeedDataSampler(copy.deepcopy(cfg), len(data), global_batch_size=8)
        if state is None:       # counter-only legacy state: the replay path
            state = {k: sd[k] for k in ("curriculum_step", "consumed_samples", "position",
                                        "admitted_size")}
        s.load_state_dict(dict(state))
        for want in expect:
            np.testing.assert_array_equal(next(s), want)


@pytest.mark.parametrize("bad,match", [
    ({"total_samples": 72}, "different dataset"),
    ({"global_batch_size": 16}, "global_batch_size"),
])
def test_data_sampler_refuses_like_jax(tmp_path, bad, match):
    data = _metric_dataset()
    tda.DataAnalyzer(data, ["seqlen"], [lambda s: s["seqlen"]], save_path=str(tmp_path)).run()
    cfg = _sampler_config(tda.metric_paths(str(tmp_path), "seqlen"), "value")
    t = tsamp.DeepSpeedDataSampler(copy.deepcopy(cfg), len(data), global_batch_size=8)
    for _ in range(3):
        next(t)
    n = bad.get("total_samples", len(data))
    bs = bad.get("global_batch_size", 8)
    for mod in (jsamp, tsamp):
        s = mod.DeepSpeedDataSampler(copy.deepcopy(cfg), n, global_batch_size=bs)
        with pytest.raises(ValueError, match=match):
            s.load_state_dict(t.state_dict())


# ------------------------------------------- engines fed through the loader
SMALL = dict(vocab_size=128, n_positions=32, n_embd=64, n_layer=2, n_head=2, remat=False)
CURRICULUM = {"enabled": True, "curriculum_type": "seqlen", "min_difficulty": 16,
              "max_difficulty": 32, "schedule_type": "fixed_discrete",
              "schedule_config": {"difficulty": [16, 32], "max_step": [3]}}


@pytest.mark.parametrize("curriculum", [False, True])
def test_engine_trains_through_training_data_like_jax(curriculum):
    """initialize(training_data=...) in both packages, six steps through each
    engine's own loader (with the seqlen curriculum: 16 tokens for three
    steps, then 32): the same batches and losses at 1e-4."""
    cfg = {"train_batch_size": 8, "steps_per_print": 0, "gradient_clipping": 1.0,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}}}
    if curriculum:
        cfg["curriculum_learning"] = dict(CURRICULUM)
    data = [{"input_ids": ids} for ids in np.random.RandomState(4).randint(
        0, SMALL["vocab_size"], size=(40, 32)).astype(np.int32)]
    jcfg = jgpt2.GPT2Config(**SMALL, dtype=jnp.float32)
    params = jgpt2.GPT2Model(jcfg).init_params(jax.random.PRNGKey(2))
    jeng, _, jloader, _ = deepspeed_tpu.initialize(
        model=jgpt2.GPT2Model(jcfg), model_parameters=params, config=dict(cfg),
        training_data=data)
    tmodel = tgpt2.params_from_jax(jax.tree.map(np.asarray, params),
                                   tgpt2.GPT2Config(**SMALL, dtype=torch.float32))
    teng, _, tloader, _ = deepspeed_tpu_torch.initialize(model=tmodel, config=dict(cfg),
                                                         training_data=data, device="cpu")
    assert isinstance(tloader, tdl.DeepSpeedDataLoader) and tloader is teng.dataloader
    assert len(tloader) == len(jloader) == 5
    jit, tit = iter(jdl.RepeatingLoader(jloader)), iter(tdl.RepeatingLoader(tloader))
    jl = [float(jeng.train_batch(data_iter=jit)) for _ in range(6)]
    tl = [float(teng.train_batch(data_iter=tit)) for _ in range(6)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tloader.state_dict() == jloader.state_dict()
    assert teng.micro_steps == jeng.micro_steps == 6
    assert teng.global_samples == jeng.global_samples == 48
    if curriculum:
        assert teng.curriculum_scheduler.get_current_difficulty() == \
            jeng.curriculum_scheduler.get_current_difficulty() == 32


def test_engine_builds_the_sampler_like_jax(tmp_path):
    """The metric curriculum sampler is built on route='train' only; an
    eval loader built first does not bind it; drop_last comes from the
    ds_config's dataloader_drop_last."""
    data = _metric_dataset()
    tda.DataAnalyzer(data, ["seqlen"], [lambda s: s["seqlen"]], save_path=str(tmp_path)).run()
    de = _sampler_config(tda.metric_paths(str(tmp_path), "seqlen"), "percentile", seed=3)
    cfg = {"train_batch_size": 8, "steps_per_print": 0, "dataloader_drop_last": False,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}, "data_efficiency": de}
    samples = [{"input_ids": d["input_ids"] % SMALL["vocab_size"]} for d in data]
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32)),
        config=dict(cfg), device="cpu")
    jeng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.GPT2Model(jgpt2.GPT2Config(**SMALL, dtype=jnp.float32)), config=dict(cfg))
    loaders = []
    for eng in (teng, jeng):
        eval_loader = eng.deepspeed_io(samples[:8], route="eval")
        assert getattr(eng, "_data_sampler", None) is None and eval_loader.drop_last is False
        loaders.append(eng.deepspeed_io(samples, route="train"))
        assert eng._data_sampler is not None and loaders[-1].data_sampler is eng._data_sampler
    tit, jit = (iter(x) for x in loaders)
    for _ in range(4):
        _assert_batches_equal(next(jit), next(tit))
    _assert_sampler_states_equal(teng._data_sampler.state_dict(), jeng._data_sampler.state_dict())


def test_custom_curriculum_schedule_through_the_engine():
    """A 'custom' legacy schedule takes its function from
    set_custom_curriculum_learning_schedule, as in the JAX engine, and
    train_batch cuts each batch to it."""
    cfg = {"train_batch_size": 4, "steps_per_print": 0,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "curriculum_learning": {"enabled": True, "min_difficulty": 8, "max_difficulty": 32,
                                   "schedule_type": "custom"}}
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32)), config=cfg,
        device="cpu")
    assert eng.curriculum_learning_enabled()
    seen = []
    eng.set_custom_curriculum_learning_schedule(
        {"get_difficulty": lambda step: (seen.append(step), 8 * step)[1]})
    ids = np.zeros((4, 32), np.int32)
    for _ in range(3):
        eng.train_batch({"input_ids": ids})
    assert seen == [1, 2, 3] and eng.curriculum_scheduler.get_current_difficulty() == 24
