"""``runtime/activation_checkpointing/checkpointing.py`` against the JAX
module, on the CPU.

A GPT-2 block run through ``checkpointing.checkpoint`` gives the gradients
(input and every weight) of the same block, with the same weights and
input, run through the JAX ``checkpoint`` under ``jax.grad``, at 1e-5 in
fp32: full recompute, and with ``cpu_checkpointing`` (JAX: its matmul
outputs offloaded to host memory). Under ``cpu_checkpointing`` the kept
matmul outputs are host tensors and the recompute takes them back in place of
running the matmuls. ``configure`` reads the
ds_config block and its keyword overrides as JAX does, and the engine
calls it on JAX's condition; the RNG tracker's seeds are JAX's and its
``fork`` leaves the default generator's stream as it was.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as tck

SMALL = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2, n_head=4, remat=False)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _fresh_module_state():
    yield
    tck.configure()                     # back to the defaults: full recompute
    tck.deepspeed_checkpointing_enabled = False


def _models():
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.models import gpt2 as jgpt2

    jm = jgpt2.GPT2Model(jgpt2.GPT2Config(**SMALL, dtype=jnp.float32,
                                          use_flash_attention=False))
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    tm = tgpt2.params_from_jax(params, tgpt2.GPT2Config(**SMALL, dtype=torch.float32))
    return jm, params, tm


def _jax_grads(jm, params, x, cpu):
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.runtime.activation_checkpointing import checkpointing as jck

    jck.configure(checkpoint_in_cpu=cpu)
    blk = jax.tree.map(lambda t: t[0], params["blocks"])
    loss = lambda x, b: jnp.sum(jck.checkpoint(lambda x, b: jm._block(x, b, None, None),
                                               x, b) ** 2)
    gx, gb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), blk)
    return np.asarray(gx), {k: np.asarray(v) for k, v in gb.items()}


def _port_grads(tm, x, **kw):
    for p in tm.parameters():
        p.grad = None
    xt = torch.from_numpy(x).requires_grad_()
    out = tck.checkpoint(lambda x: tm._block(x, tm.blocks[0], 0, None), xt, **kw)
    (out ** 2).sum().backward()
    return xt.grad.numpy(), {n: p.grad.numpy() for n, p in tm.blocks[0].named_parameters()}


@pytest.mark.parametrize("cpu", [False, True], ids=["recompute", "cpu_checkpointing"])
def test_block_gradients_match_jax_checkpoint(cpu):
    jm, params, tm = _models()
    x = np.random.RandomState(0).standard_normal((2, 16, 32)).astype(np.float32)
    jgx, jgb = _jax_grads(jm, params, x, cpu)
    tck.configure(checkpoint_in_cpu=cpu)
    assert tck._policy == ("offload" if cpu else None)
    tgx, tgb = _port_grads(tm, x)
    np.testing.assert_allclose(tgx, jgx, **TOL)
    assert set(tgb) == set(jgb)
    for name, g in tgb.items():
        np.testing.assert_allclose(g, jgb[name], err_msg=name, **TOL)


def test_cpu_checkpointing_keeps_the_matmul_outputs_on_the_host():
    """The forward copies out each mm/addmm output; the recompute reads
    every one back and runs no matmul; the gradients are the plain ones."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, _, tm = _models()
    x = torch.from_numpy(np.random.RandomState(1).standard_normal((2, 16, 32))
                         .astype(np.float32))
    ran = []

    class CountDots(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in tck._DOTS:
                ran.append(func)
            return func(*args, **(kwargs or {}))

    store = []
    contexts = []

    def context():
        fwd, rec = tck.offload_contexts(store)
        contexts.append(rec)
        return fwd, rec

    xt = x.clone().requires_grad_()
    with CountDots():
        out = torch.utils.checkpoint.checkpoint(
            lambda x: tm._block(x, tm.blocks[0], 0, None), xt, use_reentrant=False,
            context_fn=context)
    forward_dots = len(ran)
    # qkv, the attention projection, fc and fc2: four matmuls of a block
    assert forward_dots == 4 and len(store) == 4
    assert all(t.device.type == "cpu" for t in store)
    assert [tuple(t.shape) for t in store] == [(32, 96), (32, 32), (32, 128), (32, 32)]
    (out ** 2).sum().backward()
    # the recompute took the kept outputs back in order and stopped once it
    # had what the backward needs (torch's early stop): fc2's output feeds
    # only the bias and residual adds, whose backward keeps nothing
    assert contexts[0].next == 3
    kept = {n: p.grad.clone() for n, p in tm.blocks[0].named_parameters()}
    for p in tm.parameters():
        p.grad = None
    plain_x = x.clone().requires_grad_()
    (tm._block(plain_x, tm.blocks[0], 0, None) ** 2).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), plain_x.grad.numpy())
    for n, p in tm.blocks[0].named_parameters():
        np.testing.assert_array_equal(kept[n].numpy(), p.grad.numpy(), err_msg=n)


def test_other_policies_and_the_wrapper_match_plain_grads():
    _, _, tm = _models()
    x = np.random.RandomState(2).standard_normal((2, 16, 32)).astype(np.float32)
    for p in tm.parameters():
        p.grad = None
    xt = torch.from_numpy(x).requires_grad_()
    (tm._block(xt, tm.blocks[0], 0, None) ** 2).sum().backward()
    want = xt.grad.numpy()
    for policy in ("full", "dots", "offload"):
        gx, _ = _port_grads(tm, x, policy=policy)
        np.testing.assert_allclose(gx, want, **TOL)
    wrapped = tck.checkpoint_wrapper(lambda x: tm._block(x, tm.blocks[0], 0, None))
    xt = torch.from_numpy(x).requires_grad_()
    (wrapped(xt) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, **TOL)
    xt = torch.from_numpy(x).requires_grad_()
    (tck.non_reentrant_checkpoint(lambda x: tm._block(x, tm.blocks[0], 0, None), xt)
     ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, **TOL)


def test_configure_reads_the_block_like_jax():
    from deepspeed_tpu.runtime.activation_checkpointing import checkpointing as jck

    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    block = {"partition_activations": True, "cpu_checkpointing": True,
             "contiguous_memory_optimization": True, "number_checkpoints": 3,
             "synchronize_checkpoint_boundary": False, "profile": True}
    names = ("PARTITION_ACTIVATIONS", "CPU_CHECKPOINT", "CONTIGUOUS_CHECKPOINTING",
             "SYNCHRONIZE", "PROFILE_TIME", "num_layers")
    for source in ({"activation_checkpointing": block},
                   DeepSpeedConfig({"train_batch_size": 2, "activation_checkpointing": block})):
        jck.configure(deepspeed_config={"activation_checkpointing": block})
        tck.configure(deepspeed_config=source)
        assert [getattr(tck, n) for n in names] == [getattr(jck, n) for n in names]
        assert tck.is_configured() and tck._policy == "offload"
    jck.configure(deepspeed_config={"activation_checkpointing": block}, checkpoint_in_cpu=False,
                  num_checkpoints=7)
    tck.configure(deepspeed_config={"activation_checkpointing": block}, checkpoint_in_cpu=False,
                  num_checkpoints=7)
    assert [getattr(tck, n) for n in names] == [getattr(jck, n) for n in names]
    assert tck._policy is None
    tck.partition_activations_in_checkpoint(False)
    tck.set_num_layers(5)
    assert (tck.PARTITION_ACTIVATIONS, tck.num_layers) == (False, 5)
    assert tck.reset() is None


@pytest.mark.parametrize("block,configured", [
    ({}, False), ({"partition_activations": False, "cpu_checkpointing": False}, False),
    ({"cpu_checkpointing": True}, True), ({"partition_activations": True}, True)])
def test_the_engine_configures_on_the_jax_condition(block, configured):
    tck.deepspeed_checkpointing_enabled = False
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL, dtype=torch.float32)).init_params(
        torch.Generator().manual_seed(0))
    cfg = {"train_batch_size": 2, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "activation_checkpointing": block}
    deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    assert tck.is_configured() == configured
    if configured:
        assert tck.CPU_CHECKPOINT == block.get("cpu_checkpointing", False)


def test_rng_tracker_matches_jax_seeds_and_forks():
    from deepspeed_tpu.runtime.activation_checkpointing import checkpointing as jck

    assert tck.model_parallel_cuda_manual_seed(11) == jck.model_parallel_cuda_manual_seed(11)
    tt, jt = tck.get_cuda_rng_tracker(), jck.get_cuda_rng_tracker()
    assert tt.seeds_ == jt.seeds_ == {11 + 2718}
    assert set(tt.get_states()) == set(jt.get_states()) == {"model-parallel-rng"}
    torch.manual_seed(0)
    outer = torch.rand(4)
    torch.manual_seed(0)
    with tt.fork():
        inside = torch.rand(4)
    assert torch.equal(torch.rand(4), outer)               # the default stream untouched
    assert torch.equal(inside, torch.rand(4, generator=torch.Generator().manual_seed(11 + 2718)))
    with tt.fork():
        after = torch.rand(4)
    assert not torch.equal(after, inside)                   # the named stream advanced
    saved = tt.get_states()
    tt.reset()
    assert tt.get_states() == {} and tt.seeds_ == set()
    tt.set_states(saved)
    with pytest.raises(KeyError):
        with tt.fork("no-such-state"):
            pass
    assert tck.model_parallel_reconfigure_tp_seed(3) == 3
