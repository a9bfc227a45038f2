"""Compression orchestration: the transform, ``init_compression``,
``redundancy_clean`` and ``student_initialization``.

Counterpart of ``deepspeed_tpu/compression/compress.py``. The JAX package
compiles the ``compression_training`` block into one function
``transform(params, step)`` over its param pytree, whose transformer layers
are stacked leaves with a leading L (``blocks/qkv_w``). The port's models
hold one tensor per layer (``blocks.{n}.qkv_w``), so the transform groups
them into the same stacked leaves: a parameter under one of the model's
``stacked_layers`` module lists has the JAX path of its list and its key
(``blocks/qkv_w``, lower case, slash-joined), and its layer index says
where it sits in the stack. Every statistic is taken over the stacked view,
as in JAX: one quantization group tiling covers all L layers (a group may
straddle two), one quantile threshold per pruned leaf, one head mask shared
by every layer; a stacked bias or LayerNorm gain is (L, D), two-dimensional,
so ``modules: ["blocks"]`` compresses it as JAX does.

Schedules: each technique applies from its ``schedule_offset``; MoQ's
staged bit annealing gives one window ``[off, end)`` per bit width (the
last open-ended), and eigenvalue factors stretch the windows of a stacked
leaf per layer, forward only (:meth:`CompressionTransform.set_eigenvalue_factors`).

:meth:`CompressionTransform.effective` computes a step's compressed values
and the gradient mask of each armed tensor once, without autograd (the
straight-through techniques pass the gradient unchanged, the multiplying
masks scale it by the product of the active masks), and
:meth:`CompressionTransform.transform` applies them with those gradients,
as differentiating JAX's ``transform`` does. The engine trains as the JAX
engine does, which takes its gradient at the compressed params and applies
it to the raw ones: every technique is straight-through there. The engine
keeps the compressed values in static buffers that a model reads through
its ``param_gatherer`` (:class:`CompressedParams`), so the captured decode
graph of the hybrid engine reads each step's values from the same
addresses.
"""

from __future__ import annotations

import fnmatch
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.compression import basic_ops
from deepspeed_tpu_torch.compression.config import (CompressionConfig, PruneGroupParams,
                                                    PruneSharedParams, QuantGroupParams,
                                                    QuantSharedParams)
from deepspeed_tpu_torch.utils.logging import logger

# the module lists the JAX package stacks into leaves with a leading L
DEFAULT_STACKED = ("blocks",)


def param_path(name: str, stacked: Sequence[str] = DEFAULT_STACKED) -> Tuple[str, Optional[int]]:
    """A port parameter name → (its JAX path, its layer in the stack or
    None): ``blocks.3.qkv_w`` → ("blocks/qkv_w", 3) when ``blocks`` is
    stacked, ``layers.0.w`` → ("layers/0/w", None) otherwise."""
    parts = name.split(".")
    if len(parts) >= 3 and parts[0] in stacked and parts[1].isdigit():
        return "/".join([parts[0]] + parts[2:]).lower(), int(parts[1])
    return "/".join(parts).lower(), None


def _matches_scope(path: str, modules) -> bool:
    """Module-scope match: '*' wildcard, substring, glob, then regex (only
    when the pattern compiles)."""
    for pat in modules:
        pat = str(pat).lower()
        if pat == "*" or pat in path or fnmatch.fnmatch(path, f"*{pat}*"):
            return True
        try:
            if re.search(pat, path):
                return True
        except re.error:
            pass
    return False


class _CompressApply(torch.autograd.Function):
    """``eff`` in the forward; the gradient to ``w`` is ``g * gmask``
    (``g`` when ``gmask`` is None)."""

    @staticmethod
    def forward(ctx, w, eff, gmask):
        ctx.gmask = gmask
        return eff.view_as(eff)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.gmask is None else g * ctx.gmask), None, None


def compress_apply(w: torch.Tensor, eff: torch.Tensor,
                   gmask: Optional[torch.Tensor]) -> torch.Tensor:
    """``eff`` with the compression's gradient to ``w`` (no node when no
    gradient is recorded)."""
    if not (torch.is_grad_enabled() and w.requires_grad):
        return eff
    return _CompressApply.apply(w, eff, gmask)


class _Leaf:
    """One JAX leaf: a stacked (L, ...) leaf of per-layer port tensors, or
    one port tensor."""

    def __init__(self, path: str, members: List[Tuple[Optional[int], str]], shape, dtype):
        self.path = path
        self.members = members          # [(layer or None, port name)], layer order
        self.shape = tuple(shape)       # the JAX leaf's shape
        self.dtype = dtype
        self.stacked = members[0][0] is not None


def _leaves(shapes: Mapping[str, Any], stacked: Sequence[str]) -> List[_Leaf]:
    groups: Dict[str, list] = {}
    meta = {}
    for name, t in shapes.items():
        path, layer = param_path(name, stacked)
        groups.setdefault(path, []).append((layer, name))
        meta.setdefault(path, (tuple(t.shape), t.dtype))
    out = []
    for path, members in groups.items():
        shape, dtype = meta[path]
        if members[0][0] is not None:
            members.sort()
            layers = [m[0] for m in members]
            if layers != list(range(len(layers))):
                raise ValueError(f"stacked leaf {path!r}: layers {layers} are not 0..L-1")
            shape = (len(members),) + shape
        out.append(_Leaf(path, members, shape, dtype))
    return out


def _weight_like(leaf: _Leaf) -> bool:
    return len(leaf.shape) >= 2 and leaf.dtype.is_floating_point


class CompressionTransform:
    """The compiled plan: per JAX leaf, the list of stages to apply in
    order. ``params``: the model's parameters by port name (tensors or
    anything with ``shape`` and ``dtype``); ``stacked_layers``: the module
    lists the JAX package stacks."""

    def __init__(self, config: CompressionConfig, params: Mapping[str, Any],
                 stacked_layers: Sequence[str] = DEFAULT_STACKED):
        self.config = config
        self._leaves = _leaves(params, stacked_layers)
        self._plans: List[list] = []
        self._paths: List[str] = []
        # MoQ eigenvalue coupling: per-layer integer factors stretching the
        # quantization-period schedule of stacked leaves, as (step, factors)
        # installs so the stretch is forward-only
        self._ev_factors = None
        self._ev_history: List[tuple] = []
        self._ev_layer_name = "blocks"
        n_armed = 0
        for leaf in self._leaves:
            plan = []
            if _weight_like(leaf):
                plan += self._quant_plan(leaf.path)
                plan += self._prune_plans(leaf.path)
            self._plans.append(plan)
            self._paths.append(leaf.path)
            n_armed += bool(plan)
        logger.info(f"init_compression: {n_armed} tensors armed")

    # ------------------------------------------------------------ per leaf
    def _quant_plan(self, path):
        tc = self.config.weight_quantization
        shared = QuantSharedParams.from_dict(tc.shared_parameters)
        if not shared.enabled:
            return []
        for group in tc.different_groups.values():
            if _matches_scope(path, group.modules):
                gp = QuantGroupParams.from_dict(group.params)
                sym = shared.quantization_type != "asymmetric"
                sto = shared.rounding == "stochastic"
                groups = shared.quantize_groups
                period = int(gp.quantization_period or shared.quantization_period)
                # staged bit annealing: start_bits at schedule_offset, one bit
                # fewer every quantization_period steps until target_bits, each
                # stage windowed [off, next off) so one bit width quantizes the
                # raw weights at any step (the last stage has no upper bound)
                stages = list(range(int(gp.start_bits), int(gp.target_bits) - 1, -1))
                plan = []
                for i, bits in enumerate(stages):
                    off = shared.schedule_offset + i * period
                    end = (shared.schedule_offset + (i + 1) * period
                           if i + 1 < len(stages) else None)
                    plan.append({"kind": "quant", "off": off, "end": end, "stage": i,
                                 "n_stages": len(stages), "period": period,
                                 "base": shared.schedule_offset, "bits": bits,
                                 "fn": lambda w, b=bits: (basic_ops.fake_quantize_values(
                                     w, b, groups, sym, sto), None)})
                return plan
        return []

    def _prune_plans(self, path):
        plans = []
        for tc, kind in ((self.config.sparse_pruning, "sparse"),
                         (self.config.row_pruning, "row"),
                         (self.config.channel_pruning, "channel"),
                         (self.config.head_pruning, "head")):
            shared = PruneSharedParams.from_dict(tc.shared_parameters)
            if not shared.enabled:
                continue
            for group in tc.different_groups.values():
                if not _matches_scope(path, group.modules):
                    continue
                gp = PruneGroupParams.from_dict(group.params)
                # top-k sparse pruning passes the gradient straight through
                ste = kind == "sparse" and shared.method == "topk"
                nh = int(gp.num_heads or 1)

                def fn(w, kind=kind, r=gp.dense_ratio, nh=nh, ste=ste):
                    mask = basic_ops.prune_mask(kind, w, r, nh).to(w.dtype)
                    return w * mask, None if ste else mask

                plans.append({"kind": "prune", "technique": kind, "ratio": gp.dense_ratio,
                              "off": shared.schedule_offset, "end": None, "fn": fn})
                break
        return plans

    # --------------------------------------------------- MoQ eigenvalue hook
    def any_quant_armed(self) -> bool:
        return any(e["kind"] == "quant" for plan in self._plans for e in plan)

    def any_precision_switch(self, step: int) -> bool:
        """True while some quant stage boundary still lies ahead of ``step``
        under the current (possibly stretched) schedule: once every layer is
        at its terminal bit width the eigenvalue re-estimate can stop."""
        for plan, path in zip(self._plans, self._paths):
            for e in plan:
                if e["kind"] != "quant" or e["end"] is None:
                    continue
                _, end = self._window_arrays(e, path)
                if bool(np.any(np.asarray(end) > step)):
                    return True
        return False

    def set_eigenvalue_factors(self, factors, layer_name: str = "blocks",
                               step: int = 0) -> bool:
        """Install per-layer period-stretch factors (reference
        runtime/quantize.py: ``1 + floor(ev * 4)``), effective at ``step``,
        for the quant stages of stacked leaves under ``layer_name`` whose L
        is ``len(factors)``. Forward only: the stage a layer occupies at
        ``step`` keeps its start, and only its duration and later stages
        stretch. Returns True when the factors changed."""
        f = tuple(int(x) for x in factors)
        changed = (not self._ev_history or f != self._ev_history[-1][1]
                   or layer_name != self._ev_layer_name)
        if changed:
            self._ev_history.append((int(step), f))
            self._ev_layer_name = layer_name
            self._ev_factors = f
        return bool(changed)

    def _schedule_state(self, base: int, period: int, n_stages: int, L: int):
        """Replay the installs for one (base, period) schedule → (anchor,
        stage, factors), each (L,): where the stage each layer occupies after
        the last install starts, its index, and the current stretch."""
        anchor = np.full(L, base, np.int64)
        jstage = np.zeros(L, np.int64)
        fcur = np.ones(L, np.int64)
        for s0, factors in self._ev_history:
            if len(factors) != L:
                continue
            adv = np.maximum(0, (s0 - anchor) // (period * fcur))
            adv = np.minimum(adv, (n_stages - 1) - jstage)
            anchor = anchor + adv * period * fcur
            jstage = jstage + adv
            fcur = np.asarray(factors, np.int64)
        return anchor, jstage, fcur

    def _window_arrays(self, e, path):
        """(off, end) numpy arrays of a quant stage: per layer (L,) when
        eigenvalue installs apply to this schedule, else scalars."""
        f = self._ev_factors
        if f is None or self._ev_layer_name not in path:
            return np.asarray(e["off"]), None if e["end"] is None else np.asarray(e["end"])
        anchor, j, fv = self._schedule_state(e["base"], e["period"], e["n_stages"], len(f))
        i = e["stage"]
        static_off = e["base"] + i * e["period"]
        off = np.where(i < j, static_off, anchor + (i - j) * e["period"] * fv)
        if e["end"] is None:
            return off, None
        end = np.where(i < j, static_off + e["period"],
                       anchor + (i - j + 1) * e["period"] * fv)
        return off, end

    def _stretched_window(self, e, shape, path):
        """(off, end) of a plan entry for a leaf of ``shape``: per-layer
        arrays when eigenvalue factors apply to this stacked leaf, else the
        entry's scalars."""
        if e["kind"] != "quant" or self._ev_factors is None:
            return e["off"], e["end"]
        if not (self._ev_layer_name in path and len(shape) >= 2
                and shape[0] == len(self._ev_factors)):
            return e["off"], e["end"]
        return self._window_arrays(e, path)

    # ------------------------------------------------------------- applying
    def armed(self) -> List[str]:
        """The port names of every tensor some technique compresses."""
        return [name for leaf, plan in zip(self._leaves, self._plans) if plan
                for _, name in leaf.members]

    def armed_leaves(self) -> List[_Leaf]:
        return [leaf for leaf, plan in zip(self._leaves, self._plans) if plan]

    @staticmethod
    def stack(leaf: _Leaf, read: Callable[[str], torch.Tensor]) -> torch.Tensor:
        """The leaf's values, stacked (L, ...) for a stacked leaf, from
        ``read(port name)``: one layer read at a time into the stack, so
        beyond the stack at most one layer's read is held."""
        first = read(leaf.members[0][1]).detach()
        if not leaf.stacked:
            return first
        out = torch.empty((len(leaf.members),) + tuple(first.shape), dtype=first.dtype,
                          device=first.device)
        out[0].copy_(first)
        del first
        for layer, name in leaf.members[1:]:
            out[layer].copy_(read(name))
        return out

    @staticmethod
    def _unstack(leaf: _Leaf, w: torch.Tensor, out: dict) -> None:
        for layer, name in leaf.members:
            out[name] = w[layer] if leaf.stacked else w

    @torch.no_grad()
    def leaf_effective(self, leaf: _Leaf, w: torch.Tensor, step: int, masks: bool = True
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One leaf's values ``w`` (stacked) at ``step`` and, with
        ``masks``, their gradient mask (None: the gradient passes
        unchanged). Each technique applies inside its window ``[off, end)``;
        a quant window may be per layer (the MoQ stretch)."""
        gm = None
        for e in self._plans[self._leaves.index(leaf)]:
            off, end = self._stretched_window(e, leaf.shape, leaf.path)
            active = np.asarray(step >= off if end is None else
                                (step >= off) & (step < end))
            if not active.any():
                continue
            new, mask = e["fn"](w)
            if active.ndim:                          # (L,) per-layer gate
                sel = torch.as_tensor(active, device=w.device).view(
                    (-1,) + (1,) * (w.ndim - 1))
                w = torch.where(sel, new, w)
            else:
                w = new
            del new
            if masks and mask is not None:
                gm = mask if gm is None else gm * mask
        if gm is not None:
            gm = gm.expand(w.shape)
        return w, gm

    @torch.no_grad()
    def effective(self, params: Mapping[str, torch.Tensor], step: int
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Optional[torch.Tensor]]]:
        """The armed tensors' values at ``step`` and their gradient masks
        (None: the gradient passes unchanged), by port name."""
        eff, gmask = {}, {}
        for leaf in self.armed_leaves():
            w, gm = self.leaf_effective(leaf, self.stack(leaf, params.__getitem__), step)
            self._unstack(leaf, w, eff)
            for layer, name in leaf.members:
                gmask[name] = None if gm is None else (gm[layer] if leaf.stacked else gm)
        return eff, gmask

    def transform(self, params: Mapping[str, torch.Tensor], step: int) -> Dict[str, torch.Tensor]:
        """``params`` with every armed tensor compressed at ``step``, with
        the compression's gradients (straight-through, or masked)."""
        eff, gmask = self.effective(params, step)
        return {name: compress_apply(t, eff[name], gmask[name]) if name in eff else t
                for name, t in params.items()}

    @torch.no_grad()
    def finalize(self, params: Mapping[str, torch.Tensor],
                 read: Optional[Callable[[str], torch.Tensor]] = None,
                 place: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
        """Make compression permanent (reference redundancy_clean): the
        terminal stage of every armed technique applied to ``params``.
        ``read(name)`` reads a tensor whole where ``params`` cannot (an
        engine's fetched units), one leaf at a time; ``place`` moves each
        result to where it is kept."""
        place = place or (lambda t: t)
        if read is None:
            read, out = params.__getitem__, dict(params)
        else:
            armed = set(self.armed())
            out = {name: place(read(name).detach().clone()) for name in params
                   if name not in armed}
        for leaf, plan in zip(self._leaves, self._plans):
            if not plan:
                continue
            w = self.stack(leaf, read)
            for e in plan:
                if e["end"] is None:
                    w = e["fn"](w)[0]
            cleaned = {}
            self._unstack(leaf, w, cleaned)
            out.update({name: place(t) for name, t in cleaned.items()})
            del w, cleaned
        return out


class _Compressed:
    """A module's parameters to compute with: the armed ones' compressed
    values (with their gradient to the parameter), the rest the base's."""

    def __init__(self, base, own: Mapping[str, tuple]):
        self._base, self._own = base, own

    def __getattr__(self, attr):
        entry = self._own.get(attr)
        if entry is None:
            return getattr(self._base, attr)
        value = compress_apply(*entry)
        setattr(self, attr, value)
        return value


class CompressedParams:
    """The ``param_gatherer`` of a model trained with compression: each
    armed parameter is read as its compressed value, from a static buffer
    that :meth:`refresh` rewrites for a step; the gradient of the value goes
    to the parameter unchanged (the JAX engine's gradient at the compressed
    params). ``inner``: the gatherer it composes with (None: the module's
    own parameters).

    Under ZeRO stage 3 or ``offload_param`` the inner gatherer is the
    engine's ``ZeroState`` (``zero``; ``index``: the engine's parameter
    index by name). A fetched unit's armed parameters are then served by
    its gathers: the refresh reads each stacked leaf whole, one leaf at a
    time, and hands the rank's elements of its compressed values to the
    unit (``ZeroState.serve``: kept on the card at stage 3, in host memory
    under ``offload_param``), and the gathered views, whose gradients the unit's
    buffer takes, hold them: straight-through, as at stage 1. Over several
    ranks every rank gathers the same leaves and computes the same
    statistics from them: the transform is deterministic (nearest rounding,
    quantiles by sort, stochastic rounding hashed from the values), so the
    ranks agree without a broadcast."""

    def __init__(self, model: torch.nn.Module, transform: CompressionTransform, inner=None,
                 zero=None, index: Optional[Mapping[str, int]] = None):
        self.inner = inner
        self.zero = zero
        self._transform = transform
        self._model = model
        self._index = dict(index or {})
        armed = set(transform.armed())
        # armed parameters of fetched units: served by the unit's gathers
        self._served = {} if zero is None else {
            n: self._index[n] for n in armed
            if n in self._index and zero.fetched[zero.plan.params[self._index[n]].unit]}
        self._owned: Dict[int, Dict[str, str]] = {}
        for mname, module in model.named_modules():
            prefix = f"{mname}." if mname else ""
            own = {leaf: prefix + leaf for leaf in module._parameters
                   if prefix + leaf in armed and prefix + leaf not in self._served}
            if own:
                self._owned[id(module)] = own
        self.eff: Dict[str, torch.Tensor] = {}
        self.refreshes = 0

    def read(self, name: str) -> torch.Tensor:
        """Parameter ``name``'s raw values, whole, on the card."""
        i = self._index.get(name)
        if self.zero is not None and i is not None:
            return self.zero.whole_param(i)
        return self._model.get_parameter(name).detach()

    @torch.no_grad()
    def refresh(self, step: int) -> None:
        """The compressed values at ``step`` into the static buffers
        (allocated at the first refresh) and the served copies, one stacked
        leaf at a time."""
        tr = self._transform
        for leaf in tr.armed_leaves():
            w, _ = tr.leaf_effective(leaf, tr.stack(leaf, self.read), step, masks=False)
            for layer, name in leaf.members:
                value = w[layer] if leaf.stacked else w
                i = self._served.get(name)
                if i is not None:
                    self.zero.serve(i, value)
                    continue
                buf = self.eff.get(name)
                if buf is None:
                    self.eff[name] = buf = torch.empty_like(value)
                buf.copy_(value)
            del w, value
        self.refreshes += 1

    def gather(self, module):
        base = module if self.inner is None else self.inner.gather(module)
        own = self._owned.get(id(module))
        if own is None:
            return base
        return _Compressed(base, {attr: (module._parameters[attr], self.eff[name], None)
                                  for attr, name in own.items()})

    def release(self, module) -> None:
        if self.inner is not None:
            self.inner.release(module)


def stacked_layers_of(obj) -> Sequence[str]:
    """The module lists ``obj`` (a model) stacks in the JAX package."""
    return tuple(getattr(obj, "stacked_layers", DEFAULT_STACKED))


def init_compression(model_or_engine, deepspeed_config, teacher_model=None, mpu=None):
    """Arm compression (reference compress.py:95).

    * a ``DeepSpeedEngine`` → the transform installed in the engine's
      forward path (every later ``train_batch``, ``forward``, ``eval_batch``
      and hybrid ``generate`` computes with the compressed weights), the
      engine returned;
    * an ``nn.Module`` or a mapping of named tensors → a
      ``CompressionTransform`` for manual use."""
    cfg = CompressionConfig.from_ds_config(
        deepspeed_config if isinstance(deepspeed_config, Mapping)
        else {"compression_training": getattr(deepspeed_config, "compression_config", {})})
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    if isinstance(model_or_engine, DeepSpeedEngine):
        return model_or_engine.arm_compression(cfg)
    if isinstance(model_or_engine, torch.nn.Module):
        return CompressionTransform(cfg, dict(model_or_engine.named_parameters()),
                                    stacked_layers_of(model_or_engine))
    return CompressionTransform(cfg, model_or_engine)


def redundancy_clean(model_or_params, deepspeed_config, mpu=None):
    """Post-training cleanup (reference compress.py:123): the terminal
    compression made permanent.

    * an engine → its compute-type params replaced by the cleaned values,
      as the JAX engine replaces ``state.params``; the fp32 copy the
      optimizer updates is replaced too when the engine keeps no separate
      master (fp32 training, where the JAX params are the masters), and
      left alone otherwise, as JAX leaves its masters; the engine returned;
    * an ``nn.Module`` → its parameters cleaned in place, the module
      returned;
    * a mapping of named tensors → the cleaned mapping."""
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    if isinstance(model_or_params, DeepSpeedEngine):
        engine = model_or_params
        tr = engine._compression
        if tr is None:
            tr = init_compression(engine.module, deepspeed_config)
        engine.replace_params(engine.finalize_params(tr))
        return engine
    tr = init_compression(model_or_params, deepspeed_config)
    if isinstance(model_or_params, torch.nn.Module):
        cleaned = tr.finalize(dict(model_or_params.named_parameters()))
        with torch.no_grad():
            for name, p in model_or_params.named_parameters():
                p.copy_(cleaned[name])
        return model_or_params
    return tr.finalize(model_or_params)


def student_initialization(student_params, teacher_params, deepspeed_config,
                           stacked_layers: Sequence[str] = DEFAULT_STACKED):
    """Layer-reduction student init (reference compress.py
    student_initialization) over port state dicts (or models): a stacked
    leaf whose student L is ``len(teacher_layer)`` and differs from the
    teacher's takes the teacher's layers ``teacher_layer`` (student layer i
    ← teacher layer ``teacher_layer[i]``); a leaf of the teacher's shape is
    copied; any other keeps the student's. Returns the student's state
    dict."""
    cfg = CompressionConfig.from_ds_config(deepspeed_config)
    if isinstance(student_params, torch.nn.Module):
        stacked_layers = stacked_layers_of(student_params)
        student_params = student_params.state_dict()
    if isinstance(teacher_params, torch.nn.Module):
        teacher_params = teacher_params.state_dict()
    lr = cfg.layer_reduction
    if not lr.enabled:
        return dict(teacher_params)
    idx = list(lr.teacher_layer)
    s_leaves = {leaf.path: leaf for leaf in _leaves(student_params, stacked_layers)}
    t_leaves = {leaf.path: leaf for leaf in _leaves(teacher_params, stacked_layers)}
    out = {}
    for path, s in s_leaves.items():
        t = t_leaves.get(path)
        if t is not None and t.shape != s.shape and s.shape[1:] == t.shape[1:] \
                and s.shape[0] == len(idx) and s.stacked and t.stacked:
            for layer, name in s.members:
                out[name] = teacher_params[t.members[idx[layer]][1]]
        elif t is not None and t.shape == s.shape:
            for (_, name), (_, tname) in zip(s.members, t.members):
                out[name] = teacher_params[tname]
        else:
            for _, name in s.members:
                out[name] = student_params[name]
    return out
