"""ZeRO-Offload in the port against the JAX package, on the CPU.

The ds_config offload and ``aio`` blocks parse as the JAX package parses
them (the deprecated spellings included; MiCS and quantized ZeRO still
raise). The port's own aio library, swapper and swapped Adam are held to
the JAX ones' behaviour and numbers (``tests/unit/test_offload.py``'s
``TestAio``, ``TestSwapper``, ``TestSwappedOptimizer``; swapped Adam within
1e-6). Then a small fp32 GPT-2 trains 3 steps with the optimizer state in
host memory (``device="cpu"``: the offload path runs as copies between CPU
tensors): the whole-tree update, the streamed update with chunks smaller
than a unit, serial and with ``stream_overlap``, the master on either side,
and ``offload_param: cpu`` at stages 1 and 3, each against the JAX engine in
memory (losses and params within 1e-5). ``offload_optimizer: nvme`` is held
to the JAX NVMe engine (the same tolerance), and two gloo ranks at stage 2
run both offloads against the JAX engines on the 8-device CPU mesh (the
counterpart of ``test_nvme_offload_numerics_under_dp_mesh``, rtol 1e-4 as
``test_torch_zero.py``: the ranks' reductions sum in another order). A tag
saved with offload restores bit for bit without it, on NVMe, and the other
way round.

The ranks import no JAX: this module imports it inside its functions.
"""

import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.aio import AsyncIOHandle, host_zeros
from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (flatten_state,
                                                                   wait_for_pending_saves)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.runtime.swap_tensor import AsyncTensorSwapper
from tests.torch_world import World

SMALL = dict(vocab_size=128, n_positions=32, n_embd=64, n_layer=2, n_head=2, remat=False)
T, STEPS, WORLD = 32, 3, 2
CHUNK = 4096                   # fp32 bytes per streamed chunk: 1024 elements, below every unit
KNOBS = ("DS_TPU_OFFLOAD_MASTER", "DS_TPU_FORCE_STREAMED_OFFLOAD", "DS_TPU_OFFLOAD_CHUNK_BYTES",
         "DS_TPU_OFFLOAD_OVERLAP")


def _config(zero, **extra):
    return {"train_batch_size": 8, "steps_per_print": 0, "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "zero_optimization": zero, **extra}


def _batch():
    rng = np.random.RandomState(3)
    return {"input_ids": rng.randint(0, SMALL["vocab_size"], size=(8, T)).astype(np.int32)}


def _port_engine(np_params, zero, knobs=(), dtype=torch.float32):
    for k in KNOBS:
        os.environ.pop(k, None)
    os.environ.update(dict(knobs))
    try:
        model = tgpt2.params_from_jax(np_params, tgpt2.GPT2Config(**SMALL, dtype=dtype))
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=model, config=_config(zero, **({"bf16": {"enabled": True}}
                                                 if dtype == torch.bfloat16 else {})),
            device="cpu")
    finally:
        for k in KNOBS:
            os.environ.pop(k, None)
    return engine


def _run(engine, batch):
    losses = [float(engine.train_batch(batch)) for _ in range(STEPS)]
    params = {k: v.float().numpy().copy() for k, v in engine.module_state_dict().items()}
    return losses, params


def _jax_param(jp, name):
    if name.startswith("blocks."):
        _, n, key = name.split(".")
        return jp["blocks"][key][int(n)]
    return jp[name]


def _assert_matches(got, ref, rtol=1e-5, atol=1e-5):
    losses, params = got
    np.testing.assert_allclose(losses, ref["losses"], rtol=rtol)
    assert losses[-1] < losses[0]
    for name, p in params.items():
        np.testing.assert_allclose(p, _jax_param(ref["params"], name), rtol=rtol, atol=atol,
                                   err_msg=name)


# ------------------------------------------------------------ the ranks
def _ranks(rank, world, out_dir, np_params):
    rows = {k: v[rank::world] for k, v in _batch().items()}
    out = {}
    for name, zero, knobs in (
            ("cpu", {"stage": 2, "offload_optimizer": {"device": "cpu"}},
             {"DS_TPU_FORCE_STREAMED_OFFLOAD": "1", "DS_TPU_OFFLOAD_MASTER": "host",
              "DS_TPU_OFFLOAD_CHUNK_BYTES": str(CHUNK)}),
            ("nvme", {"stage": 2, "offload_optimizer": {
                "device": "nvme", "nvme_path": os.path.join(out_dir, "swap"),
                "buffer_count": 2}}, {})):
        out[name] = _run(_port_engine(np_params, zero, knobs), rows)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX engines' runs (in memory, and NVMe) beside two gloo ranks'."""
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu
    from deepspeed_tpu.models import gpt2 as jgpt2

    jcfg = jgpt2.GPT2Config(**SMALL, dtype=jnp.float32)
    params = jgpt2.GPT2Model(jcfg).init_params(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    world = World(_ranks, WORLD, str(tmp_path_factory.mktemp("offload")), args=(np_params,))
    ref = {}
    for name, zero in (("memory", {"stage": 2}),
                       ("nvme", {"stage": 2, "offload_optimizer": {
                           "device": "nvme", "buffer_count": 2,
                           "nvme_path": str(tmp_path_factory.mktemp("jax_swap"))}})):
        eng, *_ = deepspeed_tpu.initialize(model=jgpt2.GPT2Model(jcfg), model_parameters=params,
                                           config=_config(zero))
        ref[name] = {"losses": [float(eng.train_batch(_batch())) for _ in range(STEPS)],
                     "params": jax.tree.map(np.asarray, eng.state.params)}
    return {"params": np_params, "jax": ref, "ranks": world.join()}


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("zero", [
    {"offload_optimizer": {"device": "cpu"}},
    {"offload_optimizer": {"device": "nvme", "nvme_path": "/nvme/x", "buffer_count": 8,
                           "pin_memory": True, "pipeline_read": True, "pipeline_write": True,
                           "fast_init": True, "ratio": 0.5, "stream_overlap": True}},
    {"offload_param": {"device": "cpu", "pin_memory": True}},
    {"offload_param": {"device": "nvme", "nvme_path": "/nvme/p", "buffer_count": 3,
                       "buffer_size": 1000, "max_in_cpu": 10}},
    {"cpu_offload": True},
    {"cpu_offload_param": True, "cpu_offload_use_pin_memory": True},
    {"cpu_offload": False},
])
def test_offload_blocks_parse_like_jax(zero):
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig

    cfg = {"train_batch_size": 8, "zero_optimization": {"stage": 3, **zero},
           "aio": {"block_size": 4096, "queue_depth": 4, "thread_count": 2,
                   "single_submit": True, "overlap_events": False}}
    j, t = JConfig(cfg, world_size=1), TConfig(cfg, world_size=1)
    for block in ("offload_optimizer", "offload_param"):
        jb, tb = getattr(j.zero_config, block), getattr(t.zero_config, block)
        assert (jb is None) == (tb is None), block
        if jb is not None:
            assert {k: (v.value if hasattr(v, "value") else v)
                    for k, v in jb.model_dump().items()} == vars(tb), block
    assert j.aio_config.model_dump() == vars(t.aio_config)


@pytest.mark.parametrize("zero,error", [
    ({"cpu_offload": True, "offload_optimizer": {"device": "cpu"}}, ValueError),
    ({"offload_param": {"device": "disk"}}, ValueError),
    ({"mics_shard_size": 2}, NotImplementedError),
    ({"zero_quantized_weights": True}, NotImplementedError),
    ({"zero_hpz_partition_size": 2}, NotImplementedError),
])
def test_bad_or_later_zero_blocks_raise(zero, error):
    with pytest.raises(error):
        TConfig({"train_batch_size": 8, "zero_optimization": {"stage": 3, **zero}})


def test_stream_overlap_config_wins_over_the_env(monkeypatch):
    from deepspeed_tpu_torch.runtime.engine import _resolve_stream_overlap
    from deepspeed_tpu_torch.runtime.zero.config import \
        DeepSpeedZeroOffloadOptimizerConfig as Off

    monkeypatch.setenv("DS_TPU_OFFLOAD_OVERLAP", "1")
    assert _resolve_stream_overlap(Off(device="cpu", stream_overlap=False)) is False
    assert _resolve_stream_overlap(Off(device="cpu")) is True
    assert _resolve_stream_overlap(None) is True
    monkeypatch.setenv("DS_TPU_OFFLOAD_OVERLAP", "off")
    assert _resolve_stream_overlap(Off(device="cpu", stream_overlap=True)) is True
    assert _resolve_stream_overlap(Off(device="cpu")) is False


# ------------------------------------------------------------------- aio
def test_aio_library_is_the_ports_own_source():
    from deepspeed_tpu_torch.ops import aio, op_builder

    assert aio.LIBRARY.source == op_builder.CSRC_DIR / "aio" / "ds_aio.cpp"
    assert aio.LIBRARY.library_path.parent == op_builder.BUILD_DIR


def test_aio_sync_roundtrip(tmp_path):
    h = AsyncIOHandle(block_size=4096, thread_count=4)
    src = torch.from_numpy(np.frombuffer(np.random.default_rng(0).bytes(100_000),
                                         dtype=np.uint8).copy())
    path = str(tmp_path / "blob.bin")
    h.sync_pwrite(src, path)
    assert AsyncIOHandle.file_size(path) == src.numel()
    dst = torch.zeros_like(src)
    h.sync_pread(dst, path)
    assert torch.equal(src, dst)


def test_aio_async_many_and_aligned(tmp_path):
    h = AsyncIOHandle(block_size=1 << 14, thread_count=8)
    tensors = [torch.from_numpy(np.random.default_rng(i).integers(0, 255, size=50_000)
                                .astype(np.uint8)) for i in range(8)]
    tensors.append(host_zeros(3 * 4096).random_(0, 255))      # O_DIRECT-eligible
    assert tensors[-1].data_ptr() % 4096 == 0
    for i, t in enumerate(tensors):
        h.async_pwrite(t, str(tmp_path / f"f{i}.bin"))
    h.wait()
    outs = [host_zeros(t.numel()) for t in tensors]
    for i, o in enumerate(outs):
        h.async_pread(o, str(tmp_path / f"f{i}.bin"))
    h.wait()
    for t, o in zip(tensors, outs):
        assert torch.equal(t, o)


def test_aio_counts_direct_and_buffered_chunks(tmp_path):
    """Every completed chunk is counted once, as direct or buffered: an
    unaligned tensor always goes through the page cache; an aligned one goes
    around it where the filesystem takes O_DIRECT."""
    h = AsyncIOHandle(block_size=4096, thread_count=4)
    unaligned = torch.ones(5 * 4096 + 100, dtype=torch.uint8)[100:]
    h.sync_pwrite(unaligned, str(tmp_path / "u.bin"))
    assert h.counts() == {"direct_chunks": 0, "buffered_chunks": 5, "direct_bytes": 0,
                          "buffered_bytes": 5 * 4096}
    aligned = host_zeros(3 * 4096).random_(0, 255)
    h.sync_pwrite(aligned, str(tmp_path / "a.bin"))
    back = host_zeros(3 * 4096)
    h.sync_pread(back, str(tmp_path / "a.bin"))
    assert torch.equal(back, aligned)
    c = h.counts()
    assert c["direct_chunks"] + c["buffered_chunks"] == 5 + 6
    assert c["direct_bytes"] + c["buffered_bytes"] == 11 * 4096
    assert c["direct_bytes"] == 4096 * c["direct_chunks"]


def test_aio_missing_file_and_short_read_raise(tmp_path):
    h = AsyncIOHandle()
    with pytest.raises(IOError):
        h.async_pread(torch.zeros(16, dtype=torch.uint8), str(tmp_path / "nope.bin"))
    short = str(tmp_path / "short.bin")
    h.sync_pwrite(torch.ones(100, dtype=torch.uint8), short)
    with pytest.raises(IOError):
        h.sync_pread(torch.zeros(200, dtype=torch.uint8), short)
    h.async_pread(torch.zeros(4096, dtype=torch.uint8), short)
    with pytest.raises(IOError, match="past the end"):
        h.wait()


# --------------------------------------------------------------- swapper
def test_swapper_roundtrip_and_stats(tmp_path):
    sw = AsyncTensorSwapper(str(tmp_path))
    t1 = torch.from_numpy(np.random.default_rng(1).normal(size=(64, 32)).astype(np.float32))
    t2 = torch.from_numpy(np.random.default_rng(2).normal(size=(100,)).astype(np.float16))
    sw.swap_out("layer1/w", t1)
    sw.swap_out("layer2.b", t2)
    sw.synchronize()
    sw.release("layer1/w")
    sw.release("layer2.b")
    assert sw.stats()["resident_buffers"] == 0
    assert sw.stats()["tracked_tensors"] == 2
    sw.swap_in("layer1/w")
    sw.swap_in("layer2.b")
    assert torch.equal(sw.retrieve("layer1/w"), t1)
    assert torch.equal(sw.retrieve("layer2.b"), t2)
    assert all(os.path.getsize(os.path.join(tmp_path, f)) % 4096 == 0
               for f in os.listdir(tmp_path))
    st = sw.stats()
    assert st["direct_bytes"] + st["buffered_bytes"] == st["swap_out_bytes"] + st["swap_in_bytes"]


def test_swapper_unknown_name(tmp_path):
    with pytest.raises(KeyError):
        AsyncTensorSwapper(str(tmp_path)).swap_in("ghost")


def test_swapped_adam_matches_jax(tmp_path):
    from deepspeed_tpu.runtime.swap_tensor.optimizer_swapper import \
        SwappedOptimizer as JSwapped

    from deepspeed_tpu_torch.runtime.swap_tensor.optimizer_swapper import SwappedOptimizer

    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(32, 16)).astype(np.float32),
              "b": rng.normal(size=(16,)).astype(np.float32),
              "c": rng.normal(size=(8, 8)).astype(np.float32)}
    hp = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    mine = SwappedOptimizer(str(tmp_path / "port"), "adamw", hp, buffer_count=2)
    ref = JSwapped(str(tmp_path / "jax"), "adamw", hp, buffer_count=2)
    mine.init_from_params({k: torch.from_numpy(v) for k, v in params.items()})
    ref.init_from_params(params)
    for step in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        got = mine.step({k: torch.from_numpy(g) for k, g in grads.items()}, grad_scale=0.5)
        want = ref.step(grads, grad_scale=0.5)
        for k in params:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-6)
    assert mine.step_count == 3 and mine.state_bytes() >= 12 * sum(v.size for v in params.values())


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("name,params", [("adamw", {}), ("lamb", {}), ("lion", {}),
                                         ("sgd", {"momentum": 0.9}), ("sgd", {}),
                                         ("adagrad", {"initial_accumulator_value": 0.1})])
def test_host_state_starts_as_the_optimizer_does(name, params):
    from deepspeed_tpu_torch.ops.optimizers import build_optimizer
    from deepspeed_tpu_torch.runtime.zero.offload import host_opt_state

    opt = build_optimizer(name, params)
    got = host_opt_state(opt, [5, 4096 + 3], pin=False)
    want = opt.init([torch.empty(5), torch.empty(4096 + 3)])
    for a, b in zip(got, want):
        if isinstance(b, list):
            assert all(x.data_ptr() % 4096 == 0 and torch.equal(x, y) for x, y in zip(a, b))
        else:
            assert a == b


HOST_CASES = {
    # the policy's own choice for a small model: master on the card, the
    # moments streamed in whole
    "auto": ({"stage": 1, "offload_optimizer": {"device": "cpu"}}, {}),
    "master_host_whole": ({"stage": 1, "offload_optimizer": {"device": "cpu"}},
                          {"DS_TPU_OFFLOAD_MASTER": "host"}),
    "streamed_serial": ({"stage": 1, "offload_optimizer": {"device": "cpu"}},
                        {"DS_TPU_FORCE_STREAMED_OFFLOAD": "1", "DS_TPU_OFFLOAD_MASTER": "host",
                         "DS_TPU_OFFLOAD_CHUNK_BYTES": str(CHUNK)}),
    "streamed_overlap": ({"stage": 1, "offload_optimizer": {"device": "cpu",
                                                            "stream_overlap": True}},
                         {"DS_TPU_FORCE_STREAMED_OFFLOAD": "1", "DS_TPU_OFFLOAD_MASTER": "host",
                          "DS_TPU_OFFLOAD_CHUNK_BYTES": str(CHUNK)}),
    "streamed_master_on_card": ({"stage": 0, "offload_optimizer": {"device": "cpu"}},
                                {"DS_TPU_FORCE_STREAMED_OFFLOAD": "1",
                                 "DS_TPU_OFFLOAD_CHUNK_BYTES": str(CHUNK)}),
    "param_stage1": ({"stage": 1, "offload_param": {"device": "cpu"}}, {}),
    "param_stage3": ({"stage": 3, "stage3_param_persistence_threshold": 1000,
                      "offload_param": {"device": "cpu"}, "offload_optimizer": {"device": "cpu"}},
                     {"DS_TPU_FORCE_STREAMED_OFFLOAD": "1", "DS_TPU_OFFLOAD_MASTER": "host",
                      "DS_TPU_OFFLOAD_CHUNK_BYTES": str(CHUNK)}),
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_offload_matches_jax(runs, case):
    zero, knobs = HOST_CASES[case]
    engine = _port_engine(runs["params"], zero, knobs)
    off = engine._offload
    if "offload_optimizer" in zero:
        master_host = knobs.get("DS_TPU_OFFLOAD_MASTER") == "host"
        assert off is not None and off.master_host == master_host
        assert off.streamed == ("DS_TPU_FORCE_STREAMED_OFFLOAD" in knobs)
        assert off.overlap == (case == "streamed_overlap")
        if off.streamed:
            assert off.chunk < max(u.length for u in engine._plan.units)
        assert all(t.device.type == "cpu" for t in engine.opt_state.mu + engine.opt_state.nu)
    if "offload_param" in zero:
        z = engine._zero
        assert [u.name for u, f in zip(z.plan.units, z.fetched) if not f] == \
            (["persistent"] if zero["stage"] == 3 else [])
        assert all(p.numel() == 0 for i, p in enumerate(engine._params)
                   if z.fetched[z.plan.params[i].unit])
    _assert_matches(_run(engine, _batch()), runs["jax"]["memory"])


def test_nvme_offload_matches_jax_nvme(runs, tmp_path):
    engine = _port_engine(runs["params"], {"stage": 2, "offload_optimizer": {
        "device": "nvme", "nvme_path": str(tmp_path), "buffer_count": 2}})
    assert engine._nvme_optimizer is not None and not engine._keep_master
    _assert_matches(_run(engine, _batch()), runs["jax"]["nvme"])
    files = [f for f in os.listdir(tmp_path) if f.endswith(".swp")]
    assert len(files) == 3 * len(engine._plan.units)        # master and moments per unit
    assert engine._nvme_optimizer.step_count == engine.opt_state.count == STEPS


@pytest.mark.parametrize("name", ["cpu", "nvme"])
def test_stage2_offload_over_two_ranks_matches_jax(runs, name):
    ref = runs["jax"]["memory" if name == "cpu" else "nvme"]
    for rank_out in runs["ranks"]:
        _assert_matches(rank_out[name], ref, rtol=1e-4, atol=1e-5)


def test_offloaded_tags_load_across_placements(runs, tmp_path):
    """bf16 with fp32 masters: a tag saved by the streamed host offload
    restores bit for bit into an engine without offload and into the NVMe
    engine, and one saved without offload into the host offload; each
    continues with the saver's losses."""
    streamed = ({"stage": 1, "offload_optimizer": {"device": "cpu"}},
                {"DS_TPU_FORCE_STREAMED_OFFLOAD": "1", "DS_TPU_OFFLOAD_MASTER": "host",
                 "DS_TPU_OFFLOAD_CHUNK_BYTES": str(CHUNK)})
    plain = ({"stage": 1}, {})
    nvme = ({"stage": 1, "offload_optimizer": {"device": "nvme",
                                               "nvme_path": str(tmp_path / "swap")}}, {})
    batch = _batch()
    for saver, loaders in ((streamed, (plain, nvme)), (plain, (streamed,))):
        src = _port_engine(runs["params"], *saver, dtype=torch.bfloat16)
        for _ in range(2):
            src.train_batch(batch)
        ckpt = str(tmp_path / f"ck{len(loaders)}")
        src.save_checkpoint(ckpt)
        wait_for_pending_saves()
        saved = flatten_state(src)
        after = float(src.train_batch(batch))
        for zero, knobs in loaders:
            dst = _port_engine(runs["params"], zero, knobs, dtype=torch.bfloat16)
            dst.load_checkpoint(ckpt)
            restored = flatten_state(dst)
            assert restored.keys() == saved.keys()
            for k, v in saved.items():
                assert torch.equal(restored[k], v), (zero, k)
            assert float(dst.train_batch(batch)) == after, zero
