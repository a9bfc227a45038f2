"""The port's MoE layer against the JAX package's, on the CPU.

The gating math (``_capacity``, the compact top-1 and top-2 routes, their
dense views) is held to the JAX functions on the same fp32 logits: the
experts, queue positions and capacities exactly, ``l_aux`` and the weights
at rtol 1e-6 (the same fp32 formulas), with tokens dropped, without drops
and at several capacity factors. ``MOELayer`` and ``MoE`` (with the
residual MLP) take the JAX weights and are held to the JAX output and to
every gradient under ``jax.grad`` (the gate's through the combine weights
and ``l_aux``), at the tolerances of ``test_torch_gpt2.py`` (rtol 1e-5 on
values, gradients rtol 1e-4 / atol 2e-5); the experts' activation is
``jax.nn.gelu``'s tanh approximation, which differs from ``F.gelu``'s
default by ~1e-3. Random draws come from a ``torch.Generator`` (they
cannot equal JAX's): top-2's second-expert keep rate is held to its
expectation statistically. The expert-group rank lists equal the JAX
package's, and the ``tpu`` block and the grid parse as there.
"""

import math

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.moe import MoE, MOELayer, TopKGate, top1gating, top2gating
from deepspeed_tpu_torch.moe.experts import Experts
from deepspeed_tpu_torch.moe.sharded_moe import _capacity, _top1_route, _top2_route

VAL_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
ROUTE_TOL = dict(rtol=1e-6, atol=1e-7)


def _logits(T=64, E=8, skew=0.0, seed=0):
    rs = np.random.RandomState(seed)
    logits = rs.standard_normal((T, E)).astype(np.float32)
    logits[:, 0] += skew
    return logits


def test_capacity_matches_jax():
    from deepspeed_tpu.moe.sharded_moe import _capacity as jcap

    for args in ((64, 8, 1.0, 4), (64, 8, 1.5, 4), (8, 8, 1.0, 4), (12288, 8, 1.25, 4),
                 (32, 8, 1.0, 4), (4096, 8, 1.0, 4), (7, 3, 2.5, 1)):
        assert _capacity(*args) == jcap(*args), args
    assert _capacity(12288, 8, 1.25, 4) == 1920


def _assert_route(got, want):
    l_aux, eidx, pos, w, cap = got
    j_aux, j_eidx, j_pos, j_w, j_cap = want
    assert cap == j_cap
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(j_eidx))
    kept = np.asarray(j_w) > 0
    np.testing.assert_array_equal(w.numpy() > 0, kept)
    np.testing.assert_array_equal(np.where(kept, pos.numpy(), 0), np.where(kept, j_pos, 0))
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), **ROUTE_TOL)
    np.testing.assert_allclose(l_aux.item(), float(j_aux), **ROUTE_TOL)


@pytest.mark.parametrize("cf", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("drop", [True, False])
def test_top1_route_matches_jax(cf, drop):
    import jax.numpy as jnp

    from deepspeed_tpu.moe.sharded_moe import _top1_route as jroute

    logits = _logits(skew=1.5)
    got = _top1_route(torch.from_numpy(logits), cf, 4, drop_tokens=drop)
    want = jroute(jnp.asarray(logits), cf, 4, drop_tokens=drop)
    _assert_route(got, want)
    dropped = (got[3] == 0).sum().item()
    if not drop:
        assert dropped == 0
    elif cf <= 1.0:
        assert dropped > 0


@pytest.mark.parametrize("cf", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("drop", [True, False])
def test_top2_route_without_rng_matches_jax(cf, drop):
    import jax.numpy as jnp

    from deepspeed_tpu.moe.sharded_moe import _top2_route as jroute

    logits = _logits(skew=1.5, seed=1)
    got = _top2_route(torch.from_numpy(logits), cf, 4, drop, None)
    want = jroute(jnp.asarray(logits), cf, 4, drop, None)
    _assert_route(got, want)


@pytest.mark.parametrize("k", [1, 2])
def test_dense_views_match_jax(k):
    import jax.numpy as jnp

    from deepspeed_tpu.moe import sharded_moe as jmoe

    logits = _logits(T=32, skew=1.0, seed=2)
    if k == 1:
        got = top1gating(torch.from_numpy(logits), 1.0, 2)
        want = jmoe.top1gating(jnp.asarray(logits), 1.0, 2)
    else:
        got = top2gating(torch.from_numpy(logits), 1.0, 2, True, None)
        want = jmoe.top2gating(jnp.asarray(logits), 1.0, 2, True, None)
    assert got[3] == want[3]
    if k == 1:
        # the gate's dense view: its projection, then the same routing
        gate = TopKGate(8, 8, 1, capacity_factor=5.0, eval_capacity_factor=1.0,
                        min_capacity=2)
        gate.load_state_dict({"wg": torch.eye(8)}, assign=True)
        view = gate(torch.from_numpy(logits), train=False)
        assert all(torch.equal(a, b) for a, b in zip(view, got[:3]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **ROUTE_TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].item(), float(want[0]), **ROUTE_TOL)
    # every kept token in one slot, every slot holding at most one
    assert got[2].sum(dim=(1, 2)).max() <= k and got[2].sum(dim=0).max() <= 1


def test_top2_random_keep_rate_follows_the_gate():
    """The second expert is kept with probability min(1, 2 * gate2): over
    many tokens the kept share is within 4 sigma of its expectation, and a
    generator's seed repeats the draws."""
    T, E = 20000, 8
    logits = torch.from_numpy(_logits(T=T, E=E, seed=3))
    gates = torch.softmax(logits, dim=1)
    second = torch.topk(gates, 2, dim=1).values[:, 1]
    p = torch.clamp(2 * second, max=1.0)
    runs = [_top2_route(logits, 2.0, 4, False, torch.Generator().manual_seed(s))
            for s in (5, 5, 6)]
    kept = (runs[0][3][:, 1] > 0).float()
    sigma = math.sqrt((p * (1 - p)).sum().item())
    assert abs(kept.sum().item() - p.sum().item()) < 4 * sigma
    assert torch.equal(runs[0][3], runs[1][3]) and not torch.equal(runs[0][3], runs[2][3])


def test_rsample_noise_routes_from_the_generator():
    logits = torch.from_numpy(_logits(T=256, seed=4))
    plain = _top1_route(logits, 2.0, 4)[1]
    a, b = (_top1_route(logits, 2.0, 4, "RSample", torch.Generator().manual_seed(1))[1]
            for _ in range(2))
    assert torch.equal(a, b) and not torch.equal(a, plain)


# ------------------------------------------------------ the layer vs jax.grad
D, H, E = 16, 64, 4


def _jax_moe(k, residual, cf):
    import jax

    from deepspeed_tpu.moe.layer import MoE as JMoE

    layer = JMoE(hidden_size=D, num_experts=E, k=k, capacity_factor=cf, use_residual=residual)
    params = jax.tree.map(np.asarray, layer.init_params(jax.random.PRNGKey(k)))
    params["gate"]["wg"] = params["gate"]["wg"] + np.array([0.8, 0, 0, 0], np.float32)
    if residual:
        rs = np.random.RandomState(9)
        params["coefficient"] = rs.standard_normal((D, 2)).astype(np.float32)
        params["residual"]["bi"] = rs.standard_normal(H).astype(np.float32) * 0.1
    params["experts"]["bi"] = np.random.RandomState(8).standard_normal((E, H)).astype(
        np.float32) * 0.1
    return layer, params


def _port_moe(params, k, residual, cf):
    layer = MoE(D, num_experts=E, k=k, capacity_factor=cf, use_residual=residual)
    flat = {f"gate.{n}": v for n, v in params["gate"].items()}
    flat.update({f"experts.{n}": v for n, v in params["experts"].items()})
    if residual:
        flat.update({f"residual.{n}": v for n, v in params["residual"].items()})
        flat["coefficient"] = params["coefficient"]
    layer.load_state_dict({n: torch.tensor(np.asarray(v)) for n, v in flat.items()},
                          assign=True)
    return layer


def _grad_of(tree, name):
    for key in name.split("."):
        tree = tree[key]
    return np.asarray(tree)


@pytest.mark.parametrize("k,residual,cf", [(1, False, 1.0), (1, True, 0.75), (2, False, 1.0),
                                           (2, True, 2.0)])
def test_moe_output_and_every_gradient_match_jax(k, residual, cf):
    import jax
    import jax.numpy as jnp

    layer, params = _jax_moe(k, residual, cf)
    rs = np.random.RandomState(10)
    x = rs.standard_normal((3, 8, D)).astype(np.float32)
    cot = rs.standard_normal((3, 8, D)).astype(np.float32)

    def objective(p, x):
        out, l_aux = layer(p, x, None, train=True)
        return jnp.sum(out * cot) + 3.0 * l_aux, (out, l_aux)

    # compiled once: op by op the reference takes seconds per case here
    (_, (j_out, j_aux)), (j_grads, j_dx) = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    port = _port_moe(params, k, residual, cf)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, l_aux = port(xt, train=True)
    (torch.sum(out * torch.from_numpy(cot)) + 3.0 * l_aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **VAL_TOL)
    np.testing.assert_allclose(l_aux.item(), float(j_aux), **VAL_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_dx), **GRAD_TOL)
    names = [n for n, _ in port.named_parameters()]
    assert len(names) == 5 + 5 * residual
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _grad_of(j_grads, name), err_msg=name,
                                   **GRAD_TOL)


def test_moe_layer_alone_and_eval_capacity_match_jax():
    """``MOELayer`` over a gate and experts (no residual), at the gate's
    eval capacity factor when not training."""
    import jax.numpy as jnp

    from deepspeed_tpu.moe.experts import Experts as JExperts
    from deepspeed_tpu.moe.sharded_moe import MOELayer as JLayer
    from deepspeed_tpu.moe.sharded_moe import TopKGate as JGate

    _, params = _jax_moe(1, False, 1.0)
    jgate = JGate(D, E, 1, capacity_factor=2.0, eval_capacity_factor=0.5)
    jlayer = JLayer(jgate, JExperts(E, D, H).apply_one, E)
    gate = TopKGate(D, E, 1, capacity_factor=2.0, eval_capacity_factor=0.5)
    experts = Experts(E, D, H)
    gate.load_state_dict({"wg": torch.tensor(params["gate"]["wg"])}, assign=True)
    experts.load_state_dict({n: torch.tensor(v) for n, v in params["experts"].items()},
                            assign=True)
    layer = MOELayer(gate, experts, E)
    x = np.random.RandomState(11).standard_normal((2, 16, D)).astype(np.float32)
    for train in (True, False):
        j_out, j_aux = jlayer(params["gate"], params["experts"], jnp.asarray(x), None, train)
        out, l_aux = layer(torch.from_numpy(x), train)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **VAL_TOL)
        np.testing.assert_allclose(l_aux.item(), float(j_aux), **VAL_TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_a_pinned_routing_routes_as_recorded(k):
    """``MOELayer.pinned``: a recorded routing replayed gives the recorded
    call's output and gradients bit for bit, and on other inputs keeps its
    experts and slots while the weights follow the new gates."""
    _, params = _jax_moe(k, False, 1.0)
    layer = _port_moe(params, k, False, 1.0)
    x = torch.from_numpy(np.random.RandomState(12).standard_normal((2, 8, D)).astype(
        np.float32)).requires_grad_(True)

    def run(inp):
        out, l_aux = layer(inp, train=True)
        (out.sum() + l_aux).backward()
        return out.detach(), {n: p.grad.clone() for n, p in layer.named_parameters()}

    layer.moe_layer.record = True
    out, grads = run(x)
    layer.moe_layer.record, layer.moe_layer.pinned = False, layer.moe_layer.routing
    layer.zero_grad()
    again, grads_again = run(x)
    assert torch.equal(out, again)
    assert all(torch.equal(grads[n], grads_again[n]) for n in grads)
    layer.moe_layer.record = True
    layer(x.detach() * 1.5, train=True)
    r, pinned = layer.moe_layer.routing, layer.moe_layer.pinned
    assert torch.equal(r["experts"], pinned["experts"])
    assert torch.equal(r["positions"], pinned["positions"])
    assert not torch.equal(r["weights"], pinned["weights"])


def test_experts_use_the_tanh_gelu():
    """``jax.nn.gelu``'s default: F.gelu's exact erf would differ by ~1e-3."""
    import jax
    import jax.numpy as jnp

    h = np.linspace(-4, 4, 101).astype(np.float32)
    from deepspeed_tpu_torch.moe.sharded_moe import gelu_tanh

    np.testing.assert_allclose(gelu_tanh(torch.from_numpy(h)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(h))), rtol=1e-6, atol=1e-6)
    assert (gelu_tanh(torch.from_numpy(h)) - torch.nn.functional.gelu(
        torch.from_numpy(h))).abs().max() > 1e-4


def test_expert_draws_do_not_depend_on_the_expert_parallel_size():
    """Each rank keeps its experts of the same random stream: the halves of
    ep=2 are the whole of ep=1."""
    from deepspeed_tpu_torch.models.common import assemble, init_pieces

    whole, halves = None, []
    for ep, rank in ((1, 0), (2, 0), (2, 1)):
        layer = MoE(D, num_experts=E, ep_size=ep, ep_rank=rank)
        assemble(layer, layer.param_chunks(init_pieces(torch.Generator().manual_seed(3), 100)))
        if ep == 1:
            whole = layer.state_dict()
        else:
            halves.append(layer.state_dict())
    for name in ("experts.wi", "experts.bi", "experts.wo", "experts.bo"):
        assert torch.equal(torch.cat([h[name] for h in halves]), whole[name]), name
    assert torch.equal(halves[0]["gate.wg"], whole["gate.wg"])
    with pytest.raises(ValueError, match="divide"):
        MoE(D, num_experts=3, ep_size=2)


# ----------------------------------------------------------- groups and grid
@pytest.mark.parametrize("world,mp,ep", [(16, 2, 4), (8, 1, 2), (8, 1, 8), (4, 1, 1),
                                         (12, 3, 2), (4, 1, 2)])
def test_expert_parallel_ranks_match_jax(world, mp, ep):
    from deepspeed_tpu.utils.groups import _get_expert_parallel_ranks as jranks

    from deepspeed_tpu_torch.utils.groups import _get_expert_parallel_ranks

    assert _get_expert_parallel_ranks(world, mp, ep) == jranks(world, mp, ep)


def test_reference_example_rank_lists():
    from deepspeed_tpu_torch.utils.groups import _get_expert_parallel_ranks

    ep, edp = _get_expert_parallel_ranks(16, 2, 4)
    assert ep == [[0, 2, 4, 6], [8, 10, 12, 14], [1, 3, 5, 7], [9, 11, 13, 15]]
    assert edp == [[0, 8], [2, 10], [4, 12], [6, 14], [1, 9], [3, 11], [5, 13], [7, 15]]


def test_groups_of_one_process():
    from deepspeed_tpu_torch.parallel.topology import ParallelGrid
    from deepspeed_tpu_torch.utils import groups

    g = groups.initialize(1)
    assert (g.world, g.ep_size, g.ep_rank, g.world_group, g.ep_group, g.edp_group) == \
        (1, 1, 0, None, None, None)
    assert groups.initialize(1) is g and groups.get_expert_parallel_world_size(1) == 1
    with pytest.raises(ValueError, match="divisible"):
        groups.initialize(2)
    grid = ParallelGrid()
    assert grid.topo.get_axis_names() == ["data", "expert"]
    assert grid.get_data_parallel_world_size() == 1 and grid.get_expert_parallel_rank() == 0


def test_grid_coordinates_match_the_jax_axis_order():
    from deepspeed_tpu.parallel.topology import ProcessTopology as JTopo

    from deepspeed_tpu_torch.parallel.topology import ProcessTopology

    t, j = ProcessTopology(["data", "expert"], [2, 4]), JTopo(["data", "expert"], [2, 4])
    for rank in range(8):
        assert tuple(t.get_coord(rank)) == tuple(j.get_coord(rank)) == (rank // 4, rank % 4)
    assert t.get_axis_comm_lists("expert") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert t.get_axis_comm_lists("data") == j.get_axis_comm_lists("data")


def test_tpu_block():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    base = {"train_batch_size": 8}
    cfg = DeepSpeedConfig({**base, "tpu": {"data": 2, "expert": 2,
                                            "dcn_data_parallel": False}})
    assert cfg.mesh_config.expert_size(4) == 2
    with pytest.raises(ValueError, match="needs 4 ranks"):
        cfg.mesh_config.expert_size(8)
    with pytest.raises(ValueError, match="not divisible"):
        DeepSpeedConfig({**base, "tpu": {"expert": 3}}).mesh_config.expert_size(4)
    for axis in ("pipe", "seq", "tensor", "mics", "ici"):
        with pytest.raises(NotImplementedError, match="later slice"):
            DeepSpeedConfig({**base, "tpu": {axis: 2}})
    with pytest.raises(ValueError, match="did you mean 'expert'"):
        DeepSpeedConfig({**base, "tpu": {"experts": 2}})
