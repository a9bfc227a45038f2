"""The port's compression training against the JAX package.

``compression/basic_ops.py`` on a stacked (L, in, out) leaf: fake
quantization (symmetric and asymmetric, groups straddling layers, nearest
rounding bit for bit, stochastic rounding by its statistics), the
straight-through and masked gradients, ``topk_mask`` against
``jnp.quantile`` with ties, the structured masks and the head mask shared
by every layer. ``CompressionTransform`` over a GPT-2's per-layer tensors
against JAX's over its stacked leaves (scopes, windows, stacked biases and
LayerNorm gains). The
three-call API and ``eval_batch`` on ``SimpleModel``, ``student_initialization``
onto per-layer blocks. The engine against the JAX engine is
``test_torch_compression_engine.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.compression import basic_ops as jops
from deepspeed_tpu.compression import compress as jcomp
from deepspeed_tpu.compression.config import CompressionConfig as JCompressionConfig
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models import simple as jsimple
from deepspeed_tpu_torch.compression import basic_ops as tops
from deepspeed_tpu_torch.compression import compress as tcomp
from deepspeed_tpu_torch.compression.config import CompressionConfig as TCompressionConfig
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models import simple as tsimple

L, N_IN, N_OUT = 3, 5, 12
STACKED = np.random.RandomState(0).randn(L, N_IN, N_OUT).astype(np.float32)
SMALL = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2, n_head=2, remat=False,
             use_flash_attention=False)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------- ops
@pytest.mark.parametrize("bits,groups,sym", [(8, 1, True), (4, 4, True), (8, 7, False),
                                             (4, 1, False)])
def test_fake_quantize_nearest_is_jax_bit_for_bit(bits, groups, sym):
    # groups of 180 / 4 = 45 and 180 / 7 (padded) elements straddle the layers
    want = np.asarray(jops.fake_quantize(jnp.asarray(STACKED), bits, groups, sym, False))
    got = tops.fake_quantize_values(_t(STACKED), bits, groups, sym, False).numpy()
    np.testing.assert_array_equal(got, want)
    # the same values from the per-layer tensors stacked, as the transform does
    layers = [_t(STACKED[i]) for i in range(L)]
    np.testing.assert_array_equal(
        tops.fake_quantize_values(torch.stack(layers), bits, groups, sym, False).numpy(), want)


def test_fake_quantize_gradient_is_straight_through_like_jax():
    jg = jax.grad(lambda w: (jops.fake_quantize(w, 4, 2, True, False) ** 2).sum())(
        jnp.asarray(STACKED))
    w = _t(STACKED).requires_grad_()
    (tops.fake_quantize(w, 4, 2, True, False) ** 2).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jg), rtol=1e-6)


def test_stochastic_rounding_statistics():
    """The levels are nearest rounding's grid, the rounding is unbiased, and
    the draw changes when the weights change (JAX's noise comes from its own
    generator, so the values are held by these properties, not bit for bit)."""
    w = torch.from_numpy(np.random.RandomState(1).randn(4, 256, 64).astype(np.float32))
    bits, groups = 4, 4
    qmax = 2 ** (bits - 1) - 1
    out = tops.fake_quantize_values(w, bits, groups, True, True)
    scale = w.reshape(groups, -1).abs().amax(1, keepdim=True) / qmax
    q = out.reshape(groups, -1) / scale
    np.testing.assert_allclose(q.numpy(), np.round(q.numpy()), atol=1e-4)
    assert q.abs().max() <= qmax + 1e-4
    # unbiased: the mean rounding error is far below one level
    err = (out - w).reshape(groups, -1) / scale
    assert abs(float(err.mean())) < 0.01 and float(err.abs().max()) < 1.0
    # each value rounds to one of its two neighbouring levels
    near = tops.fake_quantize_values(w, bits, groups, True, False)
    assert float(((out - near).reshape(groups, -1) / scale).abs().max()) <= 1.0 + 1e-4
    again = tops.fake_quantize_values(w, bits, groups, True, True)
    assert torch.equal(out, again)
    moved = tops.fake_quantize_values(w * 1.001, bits, groups, True, True)
    assert not torch.equal(moved / 1.001, out)


@pytest.mark.parametrize("n,q", [(180, 0.5), (180, 0.3), (1001, 0.7), (7, 0.0), (7, 1.0)])
def test_quantile_is_jnp_quantile(n, q):
    rs = np.random.RandomState(n)
    flat = rs.randn(n).astype(np.float32)
    ties = rs.randint(0, 4, size=n).astype(np.float32)       # many ties
    for a in (flat, ties):
        want = np.asarray(jnp.quantile(jnp.asarray(a), q))
        assert tops.quantile(_t(a), q).numpy() == want


@pytest.mark.parametrize("ratio", [0.5, 0.25, 0.9])
def test_topk_and_prune_masks_match_jax(ratio):
    w = jnp.asarray(STACKED)
    ties = np.round(STACKED * 2) / 2                          # ties in the scores
    np.testing.assert_array_equal(tops.topk_mask(_t(np.abs(ties)), ratio).numpy(),
                                  np.asarray(jops.topk_mask(jnp.abs(jnp.asarray(ties)), ratio)))
    for jfn, tfn in ((jops.sparse_prune, tops.sparse_prune), (jops.row_prune, tops.row_prune),
                     (jops.channel_prune, tops.channel_prune)):
        np.testing.assert_array_equal(tfn(_t(STACKED), ratio).numpy(),
                                      np.asarray(jfn(w, ratio)), err_msg=jfn.__name__)
    got = tops.head_prune(_t(STACKED), 4, ratio).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.head_prune(w, 4, ratio)))
    # one head mask for every layer
    dead = (got.reshape(L, N_IN, 4, 3) == 0).all(axis=(1, 3))
    assert (dead == dead[0]).all()


@pytest.mark.parametrize("method", ["l1", "topk"])
def test_prune_gradients_match_jax(method):
    """l1's gradient is g * mask (a comparison mask), topk's passes straight
    through (``ste_mask_apply``)."""
    target = np.random.RandomState(2).randn(*STACKED.shape).astype(np.float32)
    jg = jax.grad(lambda w: (jops.sparse_prune(w, 0.5, method) * target).sum())(
        jnp.asarray(STACKED))
    w = _t(STACKED).requires_grad_()
    (tops.sparse_prune(w, 0.5, method) * _t(target)).sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), np.asarray(jg))
    jg = jax.grad(lambda w: (jops.row_prune(w, 0.5) * target).sum())(jnp.asarray(STACKED))
    w = _t(STACKED).requires_grad_()
    (tops.row_prune(w, 0.5) * _t(target)).sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), np.asarray(jg))


def test_layer_reduce():
    np.testing.assert_array_equal(tops.layer_reduce(_t(STACKED), [0, 2]).numpy(),
                                  np.asarray(jops.layer_reduce(jnp.asarray(STACKED), [0, 2])))


# --------------------------------------------------------------- transform
def _gpt2_pair(n_layer=2, seed=0):
    """A JAX GPT-2 tree (numpy draws into the init's shapes: the JAX init
    itself runs op by op here) and the port model holding the same values."""
    cfg = {**SMALL, "n_layer": n_layer}
    shapes = jax.eval_shape(lambda: jgpt2.GPT2Model(jgpt2.GPT2Config(
        **cfg, dtype=jnp.float32)).init_params(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(seed)
    np_params = jax.tree.map(lambda s: (0.02 * rs.randn(*s.shape)).astype(np.float32), shapes)
    params = jax.tree.map(jnp.asarray, np_params)
    tmodel = tgpt2.params_from_jax(np_params, tgpt2.GPT2Config(**cfg, dtype=torch.float32))
    return params, tmodel


def _jax_leaf(jtree, name):
    path, layer = tcomp.param_path(name)
    node = jtree
    for part in path.split("/"):
        node = node[part]
    return np.asarray(node if layer is None else node[layer])


def _block(technique, modules, **shared):
    if technique == "weight_quantization":
        params = {"start_bits": 8, "target_bits": 6}
        shared = {"enabled": True, "schedule_offset": 2, "quantization_period": 2, **shared}
    else:
        params = {"dense_ratio": 0.5, **({"num_heads": 2} if technique == "head_pruning" else {})}
        shared = {"enabled": True, "schedule_offset": 3, **shared}
    return {technique: {"shared_parameters": shared,
                        "different_groups": {"g": {"params": params, "modules": modules}}}}


TRANSFORMS = [
    ({**_block("weight_quantization", ["blocks"]),
      **_block("sparse_pruning", ["blocks"])}, [0, 2, 3, 4, 6, 9]),
    (_block("weight_quantization", ["*"], quantization_type="asymmetric", quantize_groups=3),
     [1, 2, 5]),
    ({**_block("row_pruning", ["fc_w"]), **_block("channel_pruning", ["proj"])}, [2, 3]),
    (_block("head_pruning", ["qkv_w"]), [3]),
    (_block("sparse_pruning", [r"blocks/fc.*_w", "wte"], method="topk"), [3]),
]


@pytest.mark.parametrize("block,steps", TRANSFORMS)
def test_transform_over_per_layer_tensors_matches_jax(block, steps):
    params, tmodel = _gpt2_pair()
    cfg = {"compression_training": block}
    jtr = jcomp.CompressionTransform(JCompressionConfig.from_ds_config(cfg),
                                     jax.eval_shape(lambda: params))
    ttr = tcomp.init_compression(tmodel, cfg)
    named = dict(tmodel.named_parameters())
    armed = set(ttr.armed())
    # a stacked bias and LayerNorm gain are (L, D): "blocks" compresses them
    if block is TRANSFORMS[0][0]:
        assert "blocks.1.qkv_b" in armed and "blocks.0.ln1_g" in armed
        assert "lnf_g" not in armed
    jtransform = jax.jit(jtr.transform)
    for step in steps:
        want = jax.tree.map(np.asarray, jtransform(params, jnp.int32(step)))
        got = ttr.transform(named, step)
        for name, t in got.items():
            # the jitted JAX transform rounds a few quotients differently
            # (the eager one is held bit for bit above); the zeros are exact
            ref = _jax_leaf(want, name)
            np.testing.assert_allclose(t.detach().numpy(), ref, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max(),
                                       err_msg=f"{name} at step {step}")
            np.testing.assert_array_equal(t.detach().numpy() == 0, ref == 0)


def test_windows_and_any_precision_switch_match_jax():
    params, tmodel = _gpt2_pair()
    cfg = {"compression_training": _block("weight_quantization", ["blocks"])}
    jtr = jcomp.CompressionTransform(JCompressionConfig.from_ds_config(cfg),
                                     jax.eval_shape(lambda: params))
    ttr = tcomp.init_compression(tmodel, cfg)
    assert ttr.any_quant_armed() and jtr.any_quant_armed()
    for step in range(9):
        assert ttr.any_precision_switch(step) == jtr.any_precision_switch(step)
    for factors, at in (([3, 1], 3), ([1, 2], 5)):
        assert ttr.set_eigenvalue_factors(factors, step=at) == \
            jtr.set_eigenvalue_factors(factors, step=at)
        for step in range(20):
            assert ttr.any_precision_switch(step) == jtr.any_precision_switch(step), step
    jplan = next(p for p, path in zip(jtr._plans, jtr._paths) if path == "blocks/qkv_w")
    tplan = next(p for p, path in zip(ttr._plans, ttr._paths) if path == "blocks/qkv_w")
    leaf = params["blocks"]["qkv_w"]
    for je, te in zip(jplan, tplan):
        joff, jend = jtr._stretched_window(je, leaf, "blocks/qkv_w")
        toff, tend = ttr._stretched_window(te, leaf.shape, "blocks/qkv_w")
        np.testing.assert_array_equal(np.asarray(toff), np.asarray(joff))
        if jend is not None:
            np.testing.assert_array_equal(np.asarray(tend), np.asarray(jend))


def test_config_block_keys_and_bounds_like_jax():
    block = {**_block("weight_quantization", ["blocks"]), **_block("head_pruning", ["qkv"]),
             "layer_reduction": {"enabled": True, "keep_number_layer": 1, "teacher_layer": [1]}}
    j = JCompressionConfig.from_ds_config(block)
    t = TCompressionConfig.from_ds_config({"compression_training": block})
    assert t.layer_reduction.teacher_layer == j.layer_reduction.teacher_layer
    assert t.head_pruning.different_groups["g"].modules == ["qkv"]
    with pytest.raises(ValueError, match="did you mean"):
        TCompressionConfig.from_ds_config({"sparse_prunning": {}})
    with pytest.raises(ValueError, match="dense_ratio"):
        tcomp.init_compression(tsimple.SimpleModel(8, 2), {"compression_training": {
            "sparse_pruning": {"shared_parameters": {"enabled": True},
                               "different_groups": {"g": {"params": {"dense_ratio": 0.0}}}}}})


def test_three_call_api_and_eval_batch_apply_compression():
    """forward / backward / step and eval_batch compute with the compressed
    weights, which equal the JAX transform's on the same weights; the raw
    loss differs (JAX ``test_compression.py`` three-call case)."""
    block = _block("sparse_pruning", ["*"], schedule_offset=0)
    block["sparse_pruning"]["different_groups"]["g"]["params"]["dense_ratio"] = 0.3
    jmodel = jsimple.SimpleModel(hidden_dim=16, nlayers=2)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = tsimple.params_from_jax(jax.tree.map(np.asarray, jparams), 16, 2)
    rs = np.random.RandomState(0)
    x, y = rs.randn(16, 16).astype(np.float32), rs.randn(16, 16).astype(np.float32)
    engine, *_ = deepspeed_tpu_torch.initialize(model=tmodel, device="cpu", config={
        "train_batch_size": 16, "optimizer": {"type": "Adam", "params": {"lr": 0.0}},
        "compression_training": block, "steps_per_print": 0})
    loss_3call = float(engine.forward((x, y)))
    engine.backward(engine.forward((x, y)))
    engine.step()
    loss_eval = float(engine.eval_batch((x, y)))
    np.testing.assert_allclose(loss_3call, loss_eval, rtol=1e-6)
    jtr = jcomp.init_compression(jparams, {"compression_training": block})
    want = float(jmodel.loss(jtr.transform(jparams, jnp.int32(0)), (jnp.asarray(x),
                                                                    jnp.asarray(y))))
    np.testing.assert_allclose(loss_eval, want, rtol=1e-5)
    raw = float(jmodel.loss(jparams, (jnp.asarray(x), jnp.asarray(y))))
    assert abs(raw - loss_eval) > 1e-6


def test_student_initialization_onto_per_layer_blocks():
    cfg = {"compression_training": {"layer_reduction": {
        "enabled": True, "keep_number_layer": 1, "teacher_layer": [1]}}}
    params, teacher = _gpt2_pair()
    jstudent, student = _gpt2_pair(n_layer=1, seed=1)
    want = jax.tree.map(np.asarray, jcomp.student_initialization(jstudent, params, cfg))
    got = tcomp.student_initialization(student, teacher, cfg)
    assert set(got) == set(student.state_dict())
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), _jax_leaf(want, name), err_msg=name)
    np.testing.assert_array_equal(got["blocks.0.qkv_w"].numpy(),
                                  teacher.state_dict()["blocks.1.qkv_w"].numpy())
