"""The port's block-sparse attention against the JAX package.

Layouts, the pair lists, the three kernels' plain versions, the autograd
function and ``SparseSelfAttention`` are held against
``deepspeed_tpu/ops/sparse_attention`` and the Pallas sparse kernels of
``deepspeed_tpu/ops/pallas/flash_attention.py``, which run here in interpret
mode (the monkeypatch of tests/unit/test_sparse_attention.py). Inputs are
numpy draws from fixed seeds. Both sides compute in fp32 on the CPU and
differ only in summation order over at most 128 keys: atol = rtol = 1e-4.
Pallas interpret mode is slow on the sparse grid, so the interpreted
comparisons use tiny grids (T <= 128, blocks >= 32, B*H <= 4). The CUDA
kernels themselves run only on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.pallas.flash_attention as jfa
import deepspeed_tpu.ops.sparse_attention as jsa
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.pallas import flash_attention as tfa

TOL = dict(atol=1e-4, rtol=1e-4)
NAMES = ("DenseSparsityConfig", "FixedSparsityConfig", "VariableSparsityConfig",
         "BigBirdSparsityConfig", "BSLongformerSparsityConfig",
         "LocalSlidingWindowSparsityConfig")


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    if jax.default_backend() != "tpu":
        from jax.experimental import pallas as pl

        monkeypatch.setattr(jfa.pl, "pallas_call",
                            functools.partial(pl.pallas_call, interpret=True))
    yield


def _layout(name, T, **kw):
    """The same layout from both packages."""
    jl = getattr(jsa, name)(num_heads=4, **kw).make_layout(T)
    tl = getattr(tsa, name)(num_heads=4, **kw).make_layout(T)
    return jl, tl


def _inputs(shape, seed, n=4):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(shape).astype(np.float32) for _ in range(n)]


# -------------------------------------------------------------------- layouts
@pytest.mark.parametrize("name,T,kw", [
    ("DenseSparsityConfig", 64, dict(block=16)),
    ("FixedSparsityConfig", 128, dict(block=16, num_local_blocks=2, num_global_blocks=1)),
    ("FixedSparsityConfig", 2048, dict(block=16, num_local_blocks=4, num_global_blocks=1,
                                       attention="unidirectional",
                                       different_layout_per_head=True,
                                       num_different_global_patterns=4)),
    ("FixedSparsityConfig", 160, dict(block=16, num_local_blocks=3, num_global_blocks=2,
                                      horizontal_global_attention=True)),
    ("VariableSparsityConfig", 160, dict(block=16, local_window_blocks=[2, 3],
                                         global_block_indices=[0])),
    ("VariableSparsityConfig", 256, dict(block=32, num_random_blocks=2,
                                         global_block_indices=[1, 5],
                                         global_block_end_indices=[3, 7],
                                         horizontal_global_attention=True)),
    ("BigBirdSparsityConfig", 128, dict(block=16)),
    ("BigBirdSparsityConfig", 512, dict(block=32, num_random_blocks=3,
                                        num_sliding_window_blocks=5, num_global_blocks=2)),
    ("BSLongformerSparsityConfig", 128, dict(block=16, global_block_indices=[0])),
    ("BSLongformerSparsityConfig", 256, dict(block=16, num_sliding_window_blocks=5,
                                             global_block_indices=[2, 9],
                                             global_block_end_indices=[4, 12])),
    ("LocalSlidingWindowSparsityConfig", 128, dict(block=16)),
    ("LocalSlidingWindowSparsityConfig", 128, dict(block=32, num_sliding_window_blocks=3,
                                                   attention="bidirectional")),
])
def test_layouts_equal_jax_bit_for_bit(name, T, kw):
    jl, tl = _layout(name, T, **kw)
    assert tl.dtype == np.bool_ and tl.shape == jl.shape
    np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("name", NAMES)
def test_indivisible_seq_raises_like_jax(name):
    for pkg in (jsa, tsa):
        with pytest.raises(ValueError, match="divisible"):
            getattr(pkg, name)(num_heads=2, block=16).make_layout(100)


def test_mismatched_global_end_indices_raise_like_jax():
    for pkg in (jsa, tsa):
        with pytest.raises(ValueError):
            pkg.BSLongformerSparsityConfig(num_heads=2, global_block_indices=[0, 3],
                                           global_block_end_indices=[2])


# ----------------------------------------------------------------- pair lists
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name,T,kw", [
    ("FixedSparsityConfig", 2048, dict(block=16, num_local_blocks=4, num_global_blocks=1)),
    ("BigBirdSparsityConfig", 256, dict(block=16)),
    ("BSLongformerSparsityConfig", 256, dict(block=32, global_block_indices=[3])),
])
def test_csr_lists_equal_jax_pairs(name, T, kw, causal):
    jl, tl = _layout(name, T, **kw)
    (qi, ki, first, last, valid), (cqi, cki, _, _, cvalid) = \
        jfa._sparse_pairs(jl, causal)
    p = tfa.sparse_pairs(tl, causal, T, "cpu")
    ok = valid == 1
    rows = np.repeat(np.arange(p.n), np.diff(p.row_ptr_np))
    np.testing.assert_array_equal(rows, qi[ok])
    np.testing.assert_array_equal(p.row_cols_np, ki[ok])
    # JAX's first/last flags are the CSR bounds
    np.testing.assert_array_equal(np.flatnonzero(first[ok]), p.row_ptr_np[:-1])
    np.testing.assert_array_equal(np.flatnonzero(last[ok]) + 1, p.row_ptr_np[1:])
    cok = cvalid == 1
    cols = np.repeat(np.arange(p.n), np.diff(p.col_ptr_np))
    np.testing.assert_array_equal(cols, cki[cok])
    np.testing.assert_array_equal(p.col_rows_np, cqi[cok])
    # JAX's dummy pairs are the empty columns
    np.testing.assert_array_equal(np.flatnonzero(np.diff(p.col_ptr_np) == 0),
                                  np.sort(cki[~cok]))
    mask = p.mask.numpy()
    assert p.visible == mask.sum()
    ref = np.kron(jl, np.ones((p.block, p.block), bool))
    if causal:
        ref &= np.tril(np.ones((T, T), bool))
    np.testing.assert_array_equal(mask, ref)


def test_empty_query_row_raises_like_jax():
    lay = np.zeros((2, 2), dtype=bool)
    lay[0, 0] = True                          # query block 1 attends nothing
    with pytest.raises(ValueError, match="no key blocks"):
        jfa._sparse_pairs(lay, True)
    with pytest.raises(ValueError, match="no key blocks"):
        tfa.sparse_pairs(lay, True, 64, "cpu")
    q = torch.zeros(1, 64, 2, 64)
    with pytest.raises(ValueError, match="no key blocks"):
        tfa.flash_attention_sparse(q, q, q, lay)
    # an above-diagonal block alone is dropped by the causal cut
    lay[1, 1], lay[0, 0] = True, False
    lay[0, 1] = True
    with pytest.raises(ValueError, match="no key blocks"):
        tfa.sparse_pairs(lay, True, 64, "cpu")
    tfa.sparse_pairs(lay, False, 64, "cpu")     # not causal: fine


def test_indivisible_seq_raises_in_attention():
    lay = np.ones((3, 3), dtype=bool)
    q = torch.zeros(1, 64, 2, 64)
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention_sparse(q, q, q, lay)
    with pytest.raises(ValueError, match="divisible"):
        jfa.flash_attention_sparse(jnp.zeros((1, 64, 2, 64)), jnp.zeros((1, 64, 2, 64)),
                                   jnp.zeros((1, 64, 2, 64)), lay)


def test_pairs_are_built_once_per_layout_and_length():
    lay = tsa.FixedSparsityConfig(2, block=16).make_layout(64)
    a = tfa.sparse_pairs(lay, True, 64, "cpu")
    assert tfa.sparse_pairs(lay.copy(), True, 64, torch.device("cpu")) is a
    assert tfa.sparse_pairs(lay, False, 64, "cpu") is not a
    assert tfa.sparse_pairs(lay, True, 128, "cpu").block == 32


# ---------------------------------------------------- backward CTA schedules
@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_backward_schedules_select_each_kept_pair_once(name, causal, block):
    """Both sides' schedules, at the level of layout blocks and at the level
    the kernels read (16-row slices): every kept pair is selected exactly
    once, nothing outside the layout is, every own row has one owner."""
    T = 16 * block
    p = tfa.SparsePairs(getattr(tsa, name)(num_heads=4, block=block).make_layout(T), causal, T,
                        "cpu")
    n, per16 = p.n, block // tfa.CHUNK
    assert p.visible == p.mask.numpy().sum()
    for sched, lists, own_is_query in ((p.dq, p.layout, True), (p.dkv, p.layout.T, False)):
        per_block = block // sched.unit_rows
        # layout blocks: one set bit of one CTA per (own unit, partner block)
        selected = np.zeros((n * per_block, n), dtype=int)
        for c in range(sched.n_cta):
            for e in range(sched.ptr[c], sched.ptr[c + 1]):
                for slot, unit in enumerate(sched.units[c]):
                    if sched.masks[e] >> slot & 1:
                        selected[unit, sched.partners[e]] += 1
        np.testing.assert_array_equal(selected, np.repeat(lists, per_block, axis=0))
        units = np.sort(sched.units[sched.units >= 0])
        np.testing.assert_array_equal(units, np.arange(n * per_block))
        # 16-row slices: the chunk words against each warp's own rows
        owned = np.zeros(n * per16, dtype=int)
        cover = np.zeros((n * per16, n * per16), dtype=int)
        assert (np.diff(sched.chunk_ptr_np) % tfa.CTA_WARPS == 0).all()
        for c in range(sched.n_cta):
            own = sched.own_rows_np[c]
            owned[own[own >= 0] // tfa.CHUNK] += 1
            for word in sched.chunks_np[sched.chunk_ptr_np[c]:sched.chunk_ptr_np[c + 1]]:
                p0, warps = word & ~15, word & 15
                assert warps or word == 0      # a chunk with no warp is padding
                for w in range(tfa.CTA_WARPS):
                    if warps >> w & 1:
                        assert own[w] >= 0
                        cover[own[w] // tfa.CHUNK, p0 // tfa.CHUNK] += 1
        np.testing.assert_array_equal(owned, 1)
        expect = np.kron(lists, np.ones((per16, per16), dtype=int))
        if causal:      # slices wholly past the diagonal are left out
            tri = np.tril if own_is_query else np.triu
            expect = tri(expect)
        np.testing.assert_array_equal(cover, expect)


@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_query_schedule_expands_to_the_token_mask(name, causal, block):
    """The forward and dq walk the query side's schedule: its chunks,
    expanded to (query, key) token pairs, with the causal cut applied only
    to the chunk on each warp's diagonal (first key row == the warp's first
    row), are exactly ``SparsePairs.mask``."""
    T = 16 * block
    p = tfa.SparsePairs(getattr(tsa, name)(num_heads=4, block=block).make_layout(T), causal, T,
                        "cpu")
    sched, c = p.dq, tfa.CHUNK
    diag = np.tril(np.ones((c, c), dtype=bool))
    seen = np.zeros((T, T), dtype=int)
    for cta in range(sched.n_cta):
        own = sched.own_rows_np[cta]
        for word in sched.chunks_np[sched.chunk_ptr_np[cta]:sched.chunk_ptr_np[cta + 1]]:
            key0 = word & ~15
            for w in range(tfa.CTA_WARPS):
                if word >> w & 1:
                    row = own[w]
                    assert row >= 0 and not (causal and key0 > row)
                    seen[row:row + c, key0:key0 + c] += diag if causal and key0 == row else 1
    np.testing.assert_array_equal(seen, p.mask.numpy().astype(int))


def test_only_the_schedules_live_on_the_device():
    """The kernels read only the two schedules, so only their tensors are
    copied to the device; the CSR lists stay numpy arrays on the host."""
    lay = tsa.FixedSparsityConfig(2, block=16).make_layout(256)
    p = tfa.SparsePairs(lay, True, 256, "cpu")
    assert [n for n, x in vars(p).items() if torch.is_tensor(x)] == []
    assert not hasattr(p, "row_ptr") and not hasattr(p, "row_cols")
    assert all(isinstance(getattr(p, n), np.ndarray)
               for n in ("row_ptr_np", "row_cols_np", "col_ptr_np", "col_rows_np"))
    for sched in (p.dq, p.dkv):
        assert sorted(n for n, x in vars(sched).items() if torch.is_tensor(x)) == [
            "chunk_ptr", "chunks", "own_rows"]


def test_backward_schedules_are_built_once_and_live_on_the_device():
    lay = tsa.FixedSparsityConfig(2, block=16).make_layout(256)
    a = tfa.sparse_pairs(lay, True, 256, "cpu")
    b = tfa.sparse_pairs(lay.copy(), True, 256, "cpu")
    assert b.dq is a.dq and b.dkv is a.dkv
    for sched in (a.dq, a.dkv):
        assert sched.own_rows.shape == (sched.n_cta, tfa.CTA_WARPS)
        np.testing.assert_array_equal(sched.chunks.numpy(), sched.chunks_np)
        np.testing.assert_array_equal(sched.chunk_ptr.numpy(), sched.chunk_ptr_np)
        # longest CTA first: the launch order
        assert (np.diff(np.diff(sched.chunk_ptr_np)) <= 0).all()


def test_training_cell_schedules_group_blocks_that_share_partners():
    """The gpt2-1.3b cell's layout (fixed, block 16, T 2048, causal): dq
    groups neighbouring query blocks; dk/dv groups the long global columns
    together, which consecutive key blocks would not (27% useful)."""
    block = {"mode": "fixed", "block": 16, "different_layout_per_head": True,
             "num_local_blocks": 4, "num_global_blocks": 1, "attention": "unidirectional",
             "horizontal_global_attention": False, "num_different_global_patterns": 4}
    p = tfa.SparsePairs(tsa.sparse_self_attention(block, 16).get_layout(2048), True, 2048, "cpu")
    assert p.dq.n_cta == p.dkv.n_cta == 32
    assert p.dq.useful_share > 0.85 and p.dkv.useful_share > 0.74
    assert p.dq.longest == 36 and p.dkv.longest == 128


# ------------------------------------------------- plain kernels vs Pallas
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name,T,kw", [
    ("BigBirdSparsityConfig", 128, dict(block=32)),
    ("FixedSparsityConfig", 128, dict(block=32, num_local_blocks=2)),
])
def test_plain_kernels_match_pallas_on_bhtd(name, T, kw, causal):
    """sparse_forward / sparse_backward_dq / sparse_backward_dkv (CPU:
    their plain versions) against ``_sparse_forward`` and
    ``_sparse_backward`` on the same residuals."""
    D = 64
    jl, tl = _layout(name, T, **kw)
    q, k, v, do = _inputs((2, T, D), seed=T + causal)
    q = q * np.float32(D ** -0.5)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o_j, lse_j = jfa._sparse_forward(jq, jk, jv, 1.0, causal, jl)
    dq_j, dk_j, dv_j = jfa._sparse_backward((jq, jk, jv, o_j, lse_j), jdo, 1.0, causal, jl)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.sparse_forward(tq, tk, tv, tl, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), err_msg="o", **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[..., 0], err_msg="lse", **TOL)
    delta = (tdo * o).sum(-1)
    dq = tfa.sparse_backward_dq(tq, tk, tv, tdo, lse, delta, tl, causal)
    dk, dv = tfa.sparse_backward_dkv(tq, tk, tv, tdo, lse, delta, tl, causal)
    for n, g, r in (("dq", dq, dq_j), ("dk", dk, dk_j), ("dv", dv, dv_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=n, **TOL)


@pytest.mark.parametrize("name,kw", [
    ("BSLongformerSparsityConfig", dict(block=32, num_sliding_window_blocks=1,
                                        global_block_indices=[0])),
    ("BigBirdSparsityConfig", dict(block=32)),
])
def test_grads_match_jax_flash_attention_sparse(name, kw):
    """jax.grad through the JAX flash_attention_sparse (the Pallas kernels,
    interpreted) against autograd through the port's."""
    T = 64
    jl, tl = _layout(name, T, **kw)
    q, k, v, do = _inputs((1, T, 2, 64), seed=3)

    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention_sparse(q, k, v, jl, causal=True) * jnp.asarray(do))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tfa.flash_attention_sparse(tq, tk, tv, tl, causal=True).backward(torch.from_numpy(do))
    for n, g, r in zip("qkv", (tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=f"d{n}", **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_sparse_mha_reference(causal):
    """The autograd function against autograd through the port's own dense
    oracle, and its output against the JAX oracle (no kernels: fast)."""
    T = 128
    jl, tl = _layout("BigBirdSparsityConfig", T, block=16)
    q, k, v, do = _inputs((2, T, 2, 64), seed=9)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tfa.flash_attention_sparse(tq, tk, tv, tl, causal=causal)
    out.backward(torch.from_numpy(do))
    got = [t.grad.clone() for t in (tq, tk, tv)]
    for t in (tq, tk, tv):
        t.grad = None
    ref = tfa.sparse_mha_reference(tq, tk, tv, tl, causal=causal)
    ref.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), **TOL)
    j = jfa.sparse_mha_reference(*map(jnp.asarray, (q, k, v)), jl, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j), **TOL)
    for n, g, t in zip("qkv", got, (tq, tk, tv)):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), err_msg=f"d{n}", **TOL)


def test_unattended_key_block_gets_exactly_zero_grads():
    q, k, v, do = _inputs((1, 64, 2, 64), seed=5)
    lay = np.zeros((2, 2), dtype=bool)
    lay[0, 0] = lay[1, 0] = True            # both query blocks attend key block 0 only
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tfa.flash_attention_sparse(tq, tk, tv, lay, causal=True).backward(torch.from_numpy(do))
    assert torch.isfinite(tk.grad).all() and torch.isfinite(tv.grad).all()
    assert torch.equal(tk.grad[:, 32:], torch.zeros_like(tk.grad[:, 32:]))
    assert torch.equal(tv.grad[:, 32:], torch.zeros_like(tv.grad[:, 32:]))
    assert tv.grad[:, :32].abs().max() > 0
    p = tfa.sparse_pairs(lay, True, 64, "cpu")
    assert p.col_ptr_np.tolist() == [0, 2, 2]     # key block 1: an empty list


@pytest.mark.parametrize("causal", [True, False])
def test_dense_layout_equals_flash_attention(causal):
    q, k, v, do = _inputs((2, 128, 2, 64), seed=6)
    lay = tsa.DenseSparsityConfig(2, block=32).make_layout(128)
    outs, grads = [], []
    for fn in (lambda *a: tfa.flash_attention_sparse(*a, lay, causal=causal),
               lambda *a: tfa.flash_attention(*a, causal=causal)):
        tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
        o = fn(tq, tk, tv)
        o.backward(torch.from_numpy(do))
        outs.append(o.detach().numpy())
        grads.append([t.grad.numpy() for t in (tq, tk, tv)])
    np.testing.assert_allclose(outs[0], outs[1], **TOL)
    for n, a, b in zip("qkv", *grads):
        np.testing.assert_allclose(a, b, err_msg=f"d{n}", **TOL)


# ----------------------------------------------------- SparseSelfAttention
@pytest.mark.parametrize("masks", ["none", "key_padding", "attn", "both"])
def test_sparse_self_attention_matches_jax(masks):
    T = 128
    kw = dict(block=32, num_local_blocks=2)
    jmod = jsa.SparseSelfAttention(jsa.FixedSparsityConfig(num_heads=2, **kw))
    tmod = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(num_heads=2, **kw))
    q, k, v = _inputs((2, T, 2, 64), seed=7, n=3)
    rs = np.random.RandomState(8)
    kp = rs.rand(2, T) > 0.2 if masks in ("key_padding", "both") else None
    am = np.tril(rs.rand(T, T) > 0.3) | np.eye(T, dtype=bool) \
        if masks in ("attn", "both") else None
    ref = jmod(*map(jnp.asarray, (q, k, v)), causal=True, key_padding_mask=kp, attn_mask=am)
    before = dict(tfa.SPARSE_KERNEL.entry_launches)
    got = tmod(*map(torch.from_numpy, (q, k, v)), causal=True,
               key_padding_mask=None if kp is None else torch.from_numpy(kp),
               attn_mask=None if am is None else torch.from_numpy(am))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(tmod.get_layout(T), jmod.get_layout(T))
    assert tfa.SPARSE_KERNEL.entry_launches == before


def test_sparse_self_attention_from_a_config_block():
    block = {"mode": "bslongformer", "block": 16, "global_block_indices": [1]}
    mod = tsa.sparse_self_attention(block, num_heads=4)
    assert isinstance(mod.sparsity_config, tsa.BSLongformerSparsityConfig)
    assert mod.sparsity_config.global_block_indices == [1]
    assert tsa.sparse_self_attention({"block": 16}, 4).sparsity_config.num_local_blocks == 4
    with pytest.raises(ValueError, match="mode"):
        tsa.sparse_self_attention({"mode": "strided"}, 4)
    with pytest.raises(TypeError):      # a key of another mode, as in JAX
        tsa.sparse_self_attention({"mode": "fixed", "num_random_blocks": 2}, 4)


# ------------------------------------------------------------------ wrappers
def test_cpu_tensors_leave_the_launch_counts_unchanged():
    q, k, v, do = map(torch.from_numpy, _inputs((2, 64, 64), seed=10))
    lay = tsa.FixedSparsityConfig(2, block=16).make_layout(64)
    before = dict(tfa.SPARSE_KERNEL.entry_launches)
    o, lse = tfa.sparse_forward(q, k, v, lay)
    delta = (do * o).sum(-1)
    tfa.sparse_backward_dq(q, k, v, do, lse, delta, lay)
    tfa.sparse_backward_dkv(q, k, v, do, lse, delta, lay)
    tq = q.clone().requires_grad_()
    tfa.flash_attention_sparse(tq.view(2, 64, 1, 64), k.view(2, 64, 1, 64),
                               v.view(2, 64, 1, 64), lay).sum().backward()
    assert tfa.SPARSE_KERNEL.entry_launches == before
    assert set(before) == {"sparse_attention_fwd", "sparse_attention_bwd_dq",
                           "sparse_attention_bwd_dkv"}


def test_wrappers_refuse_other_devices():
    lay = tsa.FixedSparsityConfig(2, block=16).make_layout(64)
    q = torch.zeros(2, 64, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfa.sparse_forward(q, q, q, lay)
