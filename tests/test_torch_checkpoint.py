"""The port's verified checkpoints against the JAX package.

Both packages train the same two-layer GPT-2 (weights carried across, fp32
on the CPU) through ``initialize(training_data=...)`` with the metric
curriculum sampler, save tags at steps 2 and 4 and train on. Then: a port
tag has the JAX tag's files, ``client_state.json`` keys and values (except
the device facts named in ``DEVICE_FACTS``: the JAX engine runs on the test
conftest's 8-device CPU mesh, the port on one device) and manifest fields;
the port resumes bitwise where it left off; a JAX tag carried into the port
by ``state_from_jax`` continues with the JAX engine's losses at 1e-4 (the
tolerance of ``test_engine_train_batch_matches_jax``); the same corruption
makes both packages restore the same tag. The module runs with
``torch.use_deterministic_algorithms(True)``: on the CPU the embedding's
backward (an accumulating ``index_put_``) otherwise adds in a varying order,
and a bitwise comparison of two runs would hold only by chance.
"""

import copy
import importlib
import json
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.resilience import manifest as jman
from deepspeed_tpu.runtime.checkpoint_engine import consolidate as jcons
from deepspeed_tpu.runtime.checkpoint_engine import engine as jck
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.data_pipeline.data_analyzer import DataAnalyzer, metric_paths
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.resilience import manifest as tman
from deepspeed_tpu_torch.resilience import retry as tretry
from deepspeed_tpu_torch.runtime.checkpoint_engine import consolidate as tcons
from deepspeed_tpu_torch.runtime.checkpoint_engine import engine as tck
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig

# the JAX resilience package exports a function named retry
jretry = importlib.import_module("deepspeed_tpu.resilience.retry")
SMALL = dict(vocab_size=128, n_positions=32, n_embd=64, n_layer=2, n_head=2, remat=False)
N_SAMPLES, T = 48, 32
# client_state.json values that describe the devices, not the run
DEVICE_FACTS = {"dp_world_size", "world"}


def _config(paths=None, **extra):
    cfg = {"train_batch_size": 8, "steps_per_print": 0, "gradient_clipping": 1.0,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 4,
                                                        "warmup_max_lr": 1e-3,
                                                        "warmup_type": "linear"}}, **extra}
    if paths is not None:
        cfg["data_efficiency"] = {"seed": 3, "data_sampling": {
            "num_epochs": 4, "curriculum_learning": {"enabled": True, "curriculum_metrics": {
                "seqlen": {"index_to_sample_path": paths["sample_path"],
                           "index_to_metric_path": paths["metric_path"],
                           "difficulty_type": "percentile", "min_difficulty": 50,
                           "max_difficulty": 100, "schedule_type": "fixed_linear",
                           "schedule_config": {"total_curriculum_step": 6,
                                               "difficulty_step": 25}}}}}}
    return cfg


def _samples():
    rng = np.random.default_rng(1)
    return [{"input_ids": rng.integers(0, SMALL["vocab_size"], size=T).astype(np.int32),
             "seqlen": int(n)} for n in rng.integers(4, T, size=N_SAMPLES)]


def _jax_params(seed=0, **over):
    jcfg = jgpt2.GPT2Config(**{**SMALL, **over}, dtype=jnp.float32)
    return jcfg, jgpt2.GPT2Model(jcfg).init_params(jax.random.PRNGKey(seed))


def _jax_engine(cfg, data=None, seed=0, **over):
    jcfg, params = _jax_params(seed, **over)
    eng, _, loader, _ = deepspeed_tpu.initialize(model=jgpt2.GPT2Model(jcfg),
                                                 model_parameters=params, config=copy.deepcopy(cfg),
                                                 training_data=data)
    return eng, loader


def _port_engine(cfg, data=None, seed=0, dtype=torch.float32, **over):
    _, params = _jax_params(seed, **over)
    model = tgpt2.params_from_jax(jax.tree.map(np.asarray, params),
                                  tgpt2.GPT2Config(**{**SMALL, **over}, dtype=dtype))
    eng, _, loader, _ = deepspeed_tpu_torch.initialize(model=model, config=copy.deepcopy(cfg),
                                                       training_data=data, device="cpu")
    return eng, loader


def _feed(data):
    return [{"input_ids": d["input_ids"]} for d in data]


@pytest.fixture(scope="module", autouse=True)
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, deterministic):
    """Each package trains two steps, saves ``global_step2``, two more,
    saves ``global_step4`` and a side tag ``side`` (``save_latest=False``),
    then trains three more steps; the losses of those are the control."""
    root = tmp_path_factory.mktemp("runs")
    data = _samples()
    DataAnalyzer(data, ["seqlen"], [lambda s: s["seqlen"]], save_path=str(root / "idx")).run()
    cfg = _config(metric_paths(str(root / "idx"), "seqlen"))
    out = {"cfg": cfg, "data": _feed(data)}
    for name, make, wait in (("jax", _jax_engine, jck.wait_for_pending_saves),
                             ("torch", _port_engine, tck.wait_for_pending_saves)):
        eng, loader = make(cfg, out["data"])
        it = iter(loader)
        save_dir = str(root / name)
        for _ in range(2):
            eng.train_batch(data_iter=it)
        eng.save_checkpoint(save_dir)
        for _ in range(2):
            eng.train_batch(data_iter=it)
        eng.save_checkpoint(save_dir)
        eng.save_checkpoint(save_dir, tag="side", save_latest=False)
        out[f"{name}_sampler_at_4"] = eng._data_sampler.state_dict()
        out[f"{name}_cont"] = [float(eng.train_batch(data_iter=it)) for _ in range(3)]
        wait()
        out[name] = save_dir
    return out


def _copy(runs, tmp_path):
    return {k: shutil.copytree(runs[k], tmp_path / k) for k in ("jax", "torch")}


# ----------------------------------------------------------- tag layout
def test_port_tag_has_the_jax_layout(runs):
    jdir, tdir = runs["jax"], runs["torch"]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == \
        ["global_step2", "global_step4", "latest", "side"]
    assert tman.read_latest(tdir) == jman.read_latest(jdir) == "global_step4"
    for tag in ("global_step2", "global_step4", "side"):
        jt, tt = os.path.join(jdir, tag), os.path.join(tdir, tag)
        assert sorted(os.listdir(tt)) == sorted(os.listdir(jt)) == sorted(
            ["client_state.json", "data_sampler_admitted.npy", "manifest.json", "state"])
        assert os.path.isfile(os.path.join(tt, "state", "_CHECKPOINT_METADATA"))
        with open(os.path.join(jt, "client_state.json")) as f:
            jmeta = json.load(f)
        with open(os.path.join(tt, "client_state.json")) as f:
            tmeta = json.load(f)
        assert tmeta.keys() == jmeta.keys()
        assert tmeta["world"].keys() == jmeta["world"].keys()
        for key in tmeta.keys() - DEVICE_FACTS:
            assert tmeta[key] == jmeta[key], key
        # the sampler's admitted order, in the same .npy bytes
        assert open(os.path.join(tt, "data_sampler_admitted.npy"), "rb").read() == \
            open(os.path.join(jt, "data_sampler_admitted.npy"), "rb").read()
        with open(os.path.join(jt, "manifest.json")) as f:
            jm = json.load(f)
        with open(os.path.join(tt, "manifest.json")) as f:
            tm = json.load(f)
        assert tm.keys() == jm.keys()
        assert {k: tm[k] for k in ("version", "tag", "advance_latest", "commit_marker")} == \
            {k: jm[k] for k in ("version", "tag", "advance_latest", "commit_marker")}
        assert tm["files"].keys() == jm["files"].keys()
        assert tm["files"]["data_sampler_admitted.npy"] == jm["files"]["data_sampler_admitted.npy"]
        assert tm["advance_latest"] is (tag != "side")
        assert tman.verify_tag(tt) == (True, "ok") and jman.verify_tag(tt) == (True, "ok")
    assert sorted(os.listdir(os.path.join(tdir, "global_step4", "state"))) == [
        "_CHECKPOINT_METADATA", "opt_state.pt", "params.pt", "skipped_steps.pt", "step.pt"]


# ---------------------------------------------------- resume in the port
def test_port_resume_continues_bitwise(runs):
    """A fresh engine (other init) loads global_step4 and continues through
    its own loader with the uninterrupted run's losses, bit for bit, and the
    sampler's stream where it was."""
    eng, loader = _port_engine(runs["cfg"], runs["data"], seed=7)
    path, client = eng.load_checkpoint(runs["torch"])
    assert os.path.basename(path) == "global_step4" and client == {}
    assert eng.global_steps == 4 and eng.global_samples == 32 and eng.micro_steps == 4
    assert eng.lr_scheduler.last_batch_iteration == 3
    assert eng._last_recovery["tier"] == "disk" and eng._last_recovery["snapshot_step"] == 4
    sd, want = eng._data_sampler.state_dict(), runs["torch_sampler_at_4"]
    assert sd.keys() == want.keys()
    for k in sd:
        assert np.array_equal(sd[k], want[k]) if isinstance(sd[k], np.ndarray) else sd[k] == want[k]
    it = iter(loader)
    assert [float(eng.train_batch(data_iter=it)) for _ in range(3)] == runs["torch_cont"]


@pytest.mark.parametrize("async_save", [True, False])
def test_plain_loader_resume_is_bitwise(tmp_path, async_save):
    """Without a sampler: save mid-epoch, a fresh engine loads and continues
    the loader's order and the uninterrupted run's losses bit for bit; the
    state after load equals the saved state."""
    data = _feed(_samples())
    cfg = _config(checkpoint={"async_save": async_save})
    a, la = _port_engine(cfg, data)
    it = iter(la)
    for _ in range(3):
        a.train_batch(data_iter=it)
    saved = {k: v.clone() for k, v in tck.flatten_state(a).items()}
    a.save_checkpoint(str(tmp_path))
    cont = [float(a.train_batch(data_iter=it)) for _ in range(3)]
    b, lb = _port_engine(cfg, data, seed=3)
    b.load_checkpoint(str(tmp_path))
    assert a._last_save["commit_s"] >= a._last_save["write_s"] > 0
    restored = tck.flatten_state(b)
    assert restored.keys() == saved.keys()
    for k, v in saved.items():
        assert torch.equal(restored[k], v), k
    assert lb.state_dict()["sample_idx"] == 24
    itb = iter(lb)
    assert [float(b.train_batch(data_iter=itb)) for _ in range(3)] == cont


def test_async_and_sync_saves_write_identical_trees(tmp_path):
    eng, loader = _port_engine(_config(), _feed(_samples()))
    it = iter(loader)
    eng.train_batch(data_iter=it)
    for async_save in (True, False):
        eng._config.checkpoint_config.async_save = async_save
        eng.save_checkpoint(str(tmp_path / str(async_save)))
    tck.wait_for_pending_saves()
    files = lambda d: sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file())
    a, s = tmp_path / "True", tmp_path / "False"
    assert files(a) == files(s) and len(files(a)) == 8
    for rel in files(a):
        assert (a / rel).read_bytes() == (s / rel).read_bytes(), rel


def test_async_save_returns_before_the_commit_and_writes_latest_last(tmp_path, monkeypatch):
    eng, _ = _port_engine(_config(), None)
    gate, real = threading.Event(), tck._write_state
    monkeypatch.setattr(tck, "_write_state",
                        lambda *a: (gate.wait(timeout=60), real(*a))[1])
    eng.save_checkpoint(str(tmp_path))          # async by default
    tag_dir = tmp_path / "global_step0"
    assert not (tmp_path / "latest").exists() and not (tag_dir / "client_state.json").exists()
    gate.set()
    tck.wait_for_pending_saves()
    assert (tmp_path / "latest").read_text() == "global_step0"
    order = sorted(["state/_CHECKPOINT_METADATA", "client_state.json", "manifest.json"],
                   key=lambda p: os.stat(tag_dir / p).st_mtime_ns)
    assert order == ["state/_CHECKPOINT_METADATA", "client_state.json", "manifest.json"]
    assert os.stat(tmp_path / "latest").st_mtime_ns >= os.stat(tag_dir / "manifest.json").st_mtime_ns


def test_a_failed_async_commit_leaves_latest_and_load_falls_back(tmp_path, monkeypatch, caplog):
    cfg = _config(resilience={"retry": {"enabled": False}})
    eng, _ = _port_engine(cfg, None)
    eng.save_checkpoint(str(tmp_path), tag="global_step1")
    tck.wait_for_pending_saves()

    def broken(*a):
        raise OSError("disk full")

    monkeypatch.setattr(tck, "_write_state", broken)
    eng.save_checkpoint(str(tmp_path), tag="global_step2")
    tck.wait_for_pending_saves()
    assert "disk full" in eng._last_save["error"]
    assert (tmp_path / "latest").read_text() == "global_step1"
    monkeypatch.undo()
    fresh, _ = _port_engine(cfg, None, seed=5)
    path, _ = fresh.load_checkpoint(str(tmp_path))
    assert os.path.basename(path) == "global_step1"


# --------------------------------------------------- a JAX tag carried over
def test_jax_tag_continues_in_the_port(runs):
    import orbax.checkpoint as ocp

    tag_dir = os.path.join(runs["jax"], "global_step4")
    with ocp.PyTreeCheckpointer() as ckptr:
        flat = jax.tree.map(np.asarray, ckptr.restore(os.path.join(tag_dir, "state")))
    with open(os.path.join(tag_dir, "client_state.json")) as f:
        meta = json.load(f)
    meta["data_sampler"]["admitted"] = np.load(
        os.path.join(tag_dir, meta["data_sampler"].pop("admitted_file")))
    eng, loader = _port_engine(runs["cfg"], runs["data"], seed=9)
    state = tck.state_from_jax(flat)
    assert set(state) == set(tck.flatten_state(eng))
    tck.apply_flat_state(eng, state)
    tck.apply_restored_meta(eng, meta)
    assert eng.global_steps == 4 and eng.opt_state.count == 4
    it = iter(loader)
    losses = [float(eng.train_batch(data_iter=it)) for _ in range(3)]
    np.testing.assert_allclose(losses, runs["jax_cont"], rtol=1e-4)
    np.testing.assert_allclose(runs["torch_cont"], runs["jax_cont"], rtol=1e-4)


# ------------------------------------------------- corruption and fallback
def _truncate_largest_state_file(tag_dir):
    files = [p for p in (tag_dir / "state").rglob("*") if p.is_file()]
    big = max(files, key=lambda p: p.stat().st_size)
    big.write_bytes(big.read_bytes()[: big.stat().st_size // 2])


CORRUPTIONS = {
    "truncate_client_state": lambda d: (d / "client_state.json").write_text("{\"tag"),
    "drop_commit_marker": lambda d: (d / "state" / "_CHECKPOINT_METADATA").unlink(),
    "truncate_state_file": _truncate_largest_state_file,
    "garbage_manifest": lambda d: (d / "manifest.json").write_text("not json"),
    "drop_sidecar": lambda d: (d / "data_sampler_admitted.npy").unlink(),
}


@pytest.mark.parametrize("corruption", sorted(CORRUPTIONS))
def test_corrupt_newest_tag_falls_back_like_jax(runs, tmp_path, corruption):
    dirs = _copy(runs, tmp_path)
    for d in dirs.values():
        CORRUPTIONS[corruption](d / "global_step4")
        assert not tman.verify_tag(str(d / "global_step4"))[0]
        assert not jman.verify_tag(str(d / "global_step4"))[0]
    restored = {}
    for name, make in (("jax", _jax_engine), ("torch", _port_engine)):
        eng, _ = make(runs["cfg"], runs["data"], seed=4)
        path, _ = eng.load_checkpoint(str(dirs[name]))
        restored[name] = (os.path.basename(path), eng.global_steps, eng.global_samples)
    assert restored["torch"] == restored["jax"] == ("global_step2", 2, 16)


def test_explicit_tags_are_contracts_like_jax(runs, tmp_path):
    """A missing explicit tag and a corrupt one load nothing, with no
    fallback; the side tag saved with save_latest=False loads only by name."""
    dirs = _copy(runs, tmp_path)
    for d in dirs.values():
        CORRUPTIONS["truncate_client_state"](d / "global_step2")
    for name, make in (("jax", _jax_engine), ("torch", _port_engine)):
        eng, _ = make(runs["cfg"], runs["data"], seed=4)
        assert eng.load_checkpoint(str(dirs[name]), tag="global_step9") == (None, {})
        assert eng.load_checkpoint(str(dirs[name]), tag="global_step2") == (None, {})
        assert eng.global_steps == 0
        assert jman.candidate_tags(str(dirs[name])) == tman.candidate_tags(str(dirs[name])) \
            == ["global_step4", "global_step2"]
        path, _ = eng.load_checkpoint(str(dirs[name]), tag="side")
        assert os.path.basename(path) == "side" and eng.global_steps == 4


@pytest.mark.parametrize("mode", ["load_module_only", "no_optimizer_states"])
def test_partial_loads_like_jax(runs, mode):
    """Both packages take the saved weights and keep their own step and
    optimizer state (load_module_only: the params only, which the port also
    copies into its masters; no optimizer states: params and masters)."""
    kw = {"load_module_only": True} if mode == "load_module_only" else \
        {"load_optimizer_states": False}
    jeng, _ = _jax_engine(runs["cfg"], runs["data"], seed=6)
    teng, _ = _port_engine(runs["cfg"], runs["data"], seed=6)
    for name, eng in (("jax", jeng), ("torch", teng)):
        eng.load_checkpoint(runs[name], **kw)
        assert eng.global_steps == 0 and eng.global_samples == 32
    assert int(jeng.state.opt_state.count) == teng.opt_state.count == 0
    assert all(not m.any() for m in teng.opt_state.mu)
    saved = tck.read_state(os.path.join(runs["torch"], "global_step4"), ("params",), "cpu")
    jp = jax.tree.map(np.asarray, jeng.state.params)
    for n, p in teng.module.named_parameters():
        assert torch.equal(p, saved[f"params/{n}"]), n
        ref = jp["blocks"][n.split(".")[2]][int(n.split(".")[1])] if n.startswith("blocks.") \
            else jp[n]
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=1e-4, atol=1e-5, err_msg=n)


def test_layout_mismatch_raises_like_jax(runs):
    for name, make, err in (("jax", _jax_engine, jck.CheckpointLayoutError),
                            ("torch", _port_engine, tck.CheckpointLayoutError)):
        eng, _ = make(runs["cfg"], None, n_head=4)
        with pytest.raises(err, match="n_head was 2 at save but is 4 now"):
            eng.load_checkpoint(runs[name])
        assert eng.global_steps == 0


def test_candidate_order_and_verdicts_match_jax(tmp_path):
    """The two manifest modules rank and judge the same directory alike."""
    eng, _ = _port_engine(_config(checkpoint={"async_save": False}), None)
    for tag, latest in (("global_step3", True), ("global_step10", False), ("best", True),
                        ("global_step7", True)):
        eng.save_checkpoint(str(tmp_path), tag=tag, save_latest=latest)
    (tmp_path / "latest").write_text("best")
    (tmp_path / "global_step12").mkdir()
    (tmp_path / "global_step12" / "client_state.json").write_text("{}")
    for preferred in (None, "global_step10", "global_step3", "nope"):
        assert tman.candidate_tags(str(tmp_path), preferred) == \
            jman.candidate_tags(str(tmp_path), preferred)
    for tag in os.listdir(tmp_path):
        if (tmp_path / tag).is_dir():
            assert tman.verify_tag(str(tmp_path / tag))[0] == jman.verify_tag(str(tmp_path / tag))[0]
    # 'latest' names a tag without a step: nothing outranks it
    assert tman.find_restorable_tag(str(tmp_path)) == jman.find_restorable_tag(str(tmp_path)) \
        == "best"
    for tag in ("global_step7", "x12", "best", "emergency_step40"):
        assert tman.tag_step(tag) == jman.tag_step(tag)


def test_retry_policy_matches_jax():
    for attempts, deadline, fails in ((4, 30.0, 2), (3, 30.0, 5), (6, 0.2, 9)):
        calls = {}
        for name, mod in (("jax", jretry), ("torch", tretry)):
            clock, slept, n = [0.0], [], [0]

            def fn():
                n[0] += 1
                if n[0] <= fails:
                    raise OSError("flaky")
                return "ok"

            def sleep(d):
                slept.append(d)
                clock[0] += d

            policy = mod.RetryPolicy(max_attempts=attempts, deadline=deadline, seed=1)
            try:
                out = mod.retry(fn, policy, op="t", sleep=sleep, clock=lambda: clock[0])
            except OSError:
                out = "raised"
            calls[name] = (out, n[0], slept)
        assert calls["torch"] == calls["jax"]
    with pytest.raises(ValueError):
        tretry.retry(lambda: (_ for _ in ()).throw(ValueError("not retried")), tretry.NO_RETRY)


# ----------------------------------------------------------- consolidation
def test_consolidated_fp32_params_match_jax_and_the_masters(runs, tmp_path):
    jtree = jcons.consolidated_fp32_params(runs["jax"])
    ttree = tcons.consolidated_fp32_params(runs["torch"])
    want = tgpt2.params_from_jax(jtree, tgpt2.GPT2Config(**SMALL, dtype=torch.float32))
    assert ttree.keys() == dict(want.named_parameters()).keys()
    for n, p in want.named_parameters():
        np.testing.assert_allclose(ttree[n], p.detach().numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    assert tcons.checkpoint_metadata(runs["torch"])["tag"] == "global_step4"
    out = tcons.consolidate_to_file(runs["torch"], str(tmp_path / "w"))
    with np.load(out) as z:
        assert sorted(z.files) == sorted(ttree)
    with pytest.raises(NotImplementedError, match="later slice"):
        tcons.consolidate_to_file(runs["torch"], str(tmp_path / "h"), arch="gpt2")
    # a bf16 run's consolidation is its fp32 masters, not the bf16 params
    eng, _ = _port_engine(_config(bf16={"enabled": True}), None, dtype=torch.bfloat16)
    ids = np.random.RandomState(0).randint(0, SMALL["vocab_size"], size=(8, T))
    eng.train_batch({"input_ids": ids})
    eng.save_checkpoint(str(tmp_path / "bf16"))
    tck.wait_for_pending_saves()
    tree = tcons.consolidated_fp32_params(str(tmp_path / "bf16"))
    masters = tck.flatten_state(eng)
    for name in eng._param_names:
        assert np.array_equal(tree[name], masters[f"master/{name}"].numpy()), name


# ---------------------------------------------------- config and counters
def test_checkpoint_and_data_blocks_parse_like_jax_and_later_blocks_raise():
    cfg = {"train_batch_size": 8, "dataloader_drop_last": True,
           "checkpoint": {"tag_validation": "Ignore", "async_save": False,
                          "parallel_write": {"pipeline_stage": False}},
           "resilience": {"verify_on_load": False, "fallback_to_last_good": False,
                          "retry": {"max_attempts": 2, "deadline": 5.0},
                          "chaos": {"enabled": False}},
           "curriculum_learning": dict(enabled=True, min_difficulty=8, max_difficulty=16,
                                       schedule_type="fixed_linear",
                                       schedule_config={"total_curriculum_step": 2,
                                                        "difficulty_step": 8}),
           "data_efficiency": {"enabled": True, "seed": 5, "data_sampling": {"num_epochs": 2}}}
    j, t = JConfig(copy.deepcopy(cfg)), TConfig(copy.deepcopy(cfg))
    for block, fields in (("checkpoint_config", ("tag_validation", "load_universal",
                                                 "use_node_local_storage", "parallel_write",
                                                 "async_save")),
                          ("resilience", ("verify_on_load", "fallback_to_last_good"))):
        for f in fields:
            assert getattr(getattr(t, block), f) == getattr(getattr(j, block), f), f
    for f in ("enabled", "max_attempts", "base_delay", "multiplier", "max_delay", "deadline",
              "jitter"):
        assert getattr(t.resilience.retry, f) == getattr(j.resilience.retry, f), f
    assert t.dataloader_drop_last == j.dataloader_drop_last is True
    assert t.data_efficiency_config == j.data_efficiency_config
    assert TConfig({"train_batch_size": 8}).checkpoint_config.async_save is \
        JConfig({"train_batch_size": 8}).checkpoint_config.async_save is True
    for later, match in (({"rewind": {}}, "rewind"),
                         ({"resilience": {"sentinel": {"enabled": True}}}, "sentinel"),
                         ({"resilience": {"chaos": {"enabled": True, "failure_rate": 0.5}}},
                          "chaos"),
                         ({"data_efficiency": {"data_routing": {"enabled": True}}},
                          "random-LTD"),
                         ({"checkpoint": {"load_universal": True}}, "load_universal"),
                         ({"checkpoint": {"parallel_write": {"pipeline_stage": True}}},
                          "parallel_write")):
        with pytest.raises(NotImplementedError, match=match):
            TConfig({"train_batch_size": 8, **later})
    # the keys for many ranks parse as in the JAX package (tags are written
    # by rank 0 alone, so node-local storage changes nothing)
    for ranks in ({"tag_validation": "Fail"}, {"use_node_local_storage": True}):
        cfg = {"train_batch_size": 8, "checkpoint": ranks}
        j, t = JConfig(copy.deepcopy(cfg)), TConfig(copy.deepcopy(cfg))
        for f in ("tag_validation", "use_node_local_storage"):
            assert getattr(t.checkpoint_config, f) == getattr(j.checkpoint_config, f), f
        assert t.checkpoint_tag_validation_fail == j.checkpoint_tag_validation_fail
    for typo, match in (({"checkpoint": {"async_sav": True}}, "did you mean 'async_save'"),
                        ({"resilience": {"retry": {"max_atempts": 2}}},
                         "did you mean 'max_attempts'"),
                        ({"curriculum_learning": {"min_dificulty": 2}},
                         "did you mean 'min_difficulty'"),
                        ({"data_efficiency": {"data_sampling": {"num_epoch": 2}}},
                         "did you mean 'num_epochs'")):
        for cls in (JConfig, TConfig):
            with pytest.raises(ValueError, match=match):
                cls({"train_batch_size": 8, **typo})


def test_concurrent_async_saves_all_commit(tmp_path):
    """More saving threads than cores, with a short switch interval: every
    background commit is tracked and joined, and every tag verifies with
    its own 'latest'."""
    import sys

    engines = [_port_engine(_config(), None, seed=i % 4)[0] for i in range(24)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda e=e, i=i: [
            e.save_checkpoint(str(tmp_path / str(i)), tag=f"global_step{k}") for k in range(4)])
            for i, e in enumerate(engines)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        tck.wait_for_pending_saves()
    finally:
        sys.setswitchinterval(old)
    assert not tck._pending_threads
    for i in range(len(engines)):
        assert (tmp_path / str(i) / "latest").read_text() == "global_step3"
        for k in range(4):
            assert tman.verify_tag(str(tmp_path / str(i) / f"global_step{k}")) == (True, "ok")


def test_a_wait_beside_another_still_waits_for_the_commit(tmp_path, monkeypatch):
    """Two waits on one blocked commit: neither returns before the commit
    is done (a wait that took the thread off the list would let the other
    return at once)."""
    eng, _ = _port_engine(_config(), None)
    gate, real = threading.Event(), tck._write_state
    monkeypatch.setattr(tck, "_write_state", lambda *a: (gate.wait(timeout=60), real(*a))[1])
    eng.save_checkpoint(str(tmp_path))
    first = threading.Thread(target=tck.wait_for_pending_saves)
    first.start()
    first.join(timeout=0.3)
    second = threading.Thread(target=tck.wait_for_pending_saves)
    second.start()
    second.join(timeout=0.3)
    assert first.is_alive() and second.is_alive()
    assert not (tmp_path / "latest").exists()
    gate.set()
    for t in (first, second):
        t.join(timeout=60)
        assert not t.is_alive()
    assert (tmp_path / "latest").read_text() == "global_step0"
