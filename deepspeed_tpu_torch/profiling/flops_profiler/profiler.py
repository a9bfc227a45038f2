"""FLOPs profiler: the matmul and convolution flops of a step, counted as it
runs, by module.

Counterpart of ``deepspeed_tpu/profiling/flops_profiler/profiler.py``. The
JAX package walks the jaxpr of the step it compiles (``count_jaxpr_flops``)
and reads XLA's cost analysis of the compiled program. The port compiles no
program: :class:`FlopCounter` is a ``TorchDispatchMode`` that sees every
aten op the step runs, forward, backward (autograd's threads inherit the
mode) and the recompute of checkpointed blocks, and counts what the jaxpr
walk counts, every matrix product and convolution:

* ``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``addmv``, ``dot`` and
  ``vdot``: 2·M·N·K over the batch;
* ``convolution`` and ``convolution_backward``: 2 × output elements × the
  input channels (over the groups) × kernel elements each, the input and
  weight gradients as the transposed convolutions JAX differentiates into;
* the attention ops, whose CUDA kernels no aten-level count sees: the dense
  forward (the op ``ds_tpu_torch::flash_fwd``) is counted here, its
  backward and the block-sparse pair report their flops themselves
  (``ops/pallas/flash_attention.py`` ``_counted``), and all of them by the
  plain einsum path's formula (:func:`einsum_attention_flops`, the full
  square as JAX's einsum off the TPU computes it), whichever body runs;
  the plain versions' own matmuls on the CPU are not counted. So the count
  on the card equals the count on the CPU, and the JAX package's for the
  same model, config and shapes.

What the step recomputes is counted as it runs: a block under remat
"full" runs its forward again in the backward, as JAX's jaxpr holds it
twice. Under the selective policies the port saves what its policy names
(the flash forward's outputs under "attn", the ``mm`` outputs under
"dots") and counts only what it recomputes.

Scopes: with a model whose modules compute through ``_gathered(module)``
(``models/common.py``), each op is attributed to that module's name
(``blocks.3``; ``""``, printed ``<toplevel>``, for the model's own
weights); a backward op to the scope whose forward made its autograd node.

Counting happens while the step runs, on the real tensors: the mode calls
every op as it was called, so the step's values, state and generators are
those of an unprofiled step; only its time grows by the mode's host work.
XLA's compiled flop and byte counts have no CUDA counterpart: the profile's
FLOPs are 2 × MACs, as the JAX profiler reports them when the cost analysis
is absent, and it has no bytes line.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deepspeed_tpu_torch.ops.pallas.flash_attention import einsum_attention_flops

_aten = torch.ops.aten
_SCOPE_KEY = "ds_flops_scope"


# ----------------------------------------------------------------- formatting
def number_to_string(num, units=None, precision=2):
    if units is None:
        if num >= 1e12:
            return f"{num / 1e12:.{precision}f} T"
        if num >= 1e9:
            return f"{num / 1e9:.{precision}f} G"
        if num >= 1e6:
            return f"{num / 1e6:.{precision}f} M"
        if num >= 1e3:
            return f"{num / 1e3:.{precision}f} K"
        return f"{num:.{precision}f} "
    scale = {"T": 1e12, "G": 1e9, "M": 1e6, "K": 1e3, "": 1.0}[units]
    return f"{num / scale:.{precision}f} {units}"


def flops_to_string(flops, units=None, precision=2):
    return number_to_string(flops, units, precision) + "FLOPS"


def macs_to_string(macs, units=None, precision=2):
    return number_to_string(macs, units, precision) + "MACs"


def params_to_string(params_num, units=None, precision=2):
    return number_to_string(params_num, units, precision).rstrip() or "0"


def duration_to_string(duration, units=None, precision=2):
    if duration >= 1:
        return f"{duration:.{precision}f} s"
    if duration >= 1e-3:
        return f"{duration * 1e3:.{precision}f} ms"
    return f"{duration * 1e6:.{precision}f} us"


# ------------------------------------------------------------------ the count
def _mm(a, b) -> int:
    return 2 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(a, b) -> int:
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _conv_out_channels(weight, transposed: bool, groups: int) -> int:
    return weight.shape[1] * groups if transposed else weight.shape[0]


def _conv(args, out) -> int:
    """2 × output elements × the weight elements one output channel reads."""
    weight, transposed, groups = args[1], args[6], args[8]
    return 2 * out.numel() * (weight.numel() // _conv_out_channels(weight, transposed, groups))


def _conv_backward(args) -> int:
    """The input gradient (a convolution of the output gradient producing
    the input's elements, each over the weight elements one input channel
    feeds) and the weight gradient (each weight element over the batch and
    the positions it slid across), as JAX's transposed convolutions."""
    grad_out, inp, weight = args[0], args[1], args[2]
    transposed, groups, mask = args[7], args[9], args[10]
    flops = 0
    if mask[0]:
        in_channels = weight.shape[0] if transposed else weight.shape[1] * groups
        flops += 2 * inp.numel() * (weight.numel() // in_channels)
    if mask[1]:
        slid = inp if transposed else grad_out
        channels = inp.shape[1] if transposed else _conv_out_channels(weight, False, groups)
        flops += 2 * weight.numel() * (slid.numel() // channels)
    return flops


_COUNTED_OPS = {
    _aten.mm: lambda args, out: _mm(args[0], args[1]),
    _aten.addmm: lambda args, out: _mm(args[1], args[2]),
    _aten.bmm: lambda args, out: _bmm(args[0], args[1]),
    _aten.baddbmm: lambda args, out: _bmm(args[1], args[2]),
    _aten.mv: lambda args, out: 2 * args[0].numel(),
    _aten.addmv: lambda args, out: 2 * args[1].numel(),
    _aten.dot: lambda args, out: 2 * args[0].numel(),
    _aten.vdot: lambda args, out: 2 * args[0].numel(),
    torch.ops.ds_tpu_torch.flash_fwd: lambda args, out: einsum_attention_flops(
        args[0].shape[0], args[0].shape[1], args[1].shape[1], args[0].shape[2]),
    _aten.convolution: _conv,
    _aten.convolution_backward: lambda args, out: _conv_backward(args),
}


class FlopCounter(TorchDispatchMode):
    """Counts the matmul and convolution flops of the ops run under it (see
    the module docstring): ``total`` and ``per_scope`` by module name. With
    ``model`` (one whose modules compute through ``_gathered``), ops are
    scoped by module."""

    def __init__(self, model=None):
        super().__init__()
        self.total = 0
        self.per_scope: Dict[str, int] = {}
        self._model = model
        self._names = {id(m): n for n, m in model.named_modules()} if model is not None else {}
        self._stack: list = []
        self._opaque = threading.local()

    # --------------------------------------------------------------- scopes
    @contextlib.contextmanager
    def scoped(self):
        """While inside, the model's ``_gathered(module)`` opens the
        module's scope."""
        model = self._model
        if model is None or not hasattr(model, "_gathered"):
            yield
            return
        inner = model._gathered

        @contextlib.contextmanager
        def gathered(module):
            self._stack.append(self._names.get(id(module), ""))
            try:
                with inner(module) as w:
                    yield w
            finally:
                self._stack.pop()

        model._gathered = gathered
        try:
            yield
        finally:
            del model._gathered

    def _scope(self, node) -> str:
        if self._stack:
            return self._stack[-1]
        if node is not None:
            return node.metadata.get(_SCOPE_KEY, "")
        return ""

    def _add(self, flops: int, scope: str) -> None:
        self.total += flops
        self.per_scope[scope] = self.per_scope.get(scope, 0) + flops

    @contextlib.contextmanager
    def opaque(self, flops: int):
        """An op that reports its own ``flops`` (a CUDA kernel, or its plain
        version): they are added once, and the aten ops run inside are not
        counted."""
        self._add(flops, self._scope(torch._C._current_autograd_node()))
        depth = getattr(self._opaque, "depth", 0)
        self._opaque.depth = depth + 1
        try:
            yield
        finally:
            self._opaque.depth = depth

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(self._opaque, "depth", 0):
            return out
        node = torch._C._current_autograd_node()
        if node is None and self._stack:
            # a forward op: the autograd nodes of its inputs belong to the
            # scope that consumes them, so their backward ops are scoped alike
            for a in args:
                if isinstance(a, torch.Tensor) and a.grad_fn is not None:
                    a.grad_fn.metadata.setdefault(_SCOPE_KEY, self._stack[-1])
        rule = _COUNTED_OPS.get(func.overloadpacket)
        if rule is not None:
            self._add(rule(args, out), self._scope(node))
        return out


def _count_params(params) -> int:
    """Elements of a module's parameters, or of the tensors (or numpy
    arrays) in nested dicts, lists and tuples."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(_count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(_count_params(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel()
    return int(getattr(params, "size", 0))


# ------------------------------------------------------------------ profiler
class FlopsProfiler:
    """Profile what runs between :meth:`start_profile` and
    :meth:`stop_profile` (or one call, :meth:`profile_fn`), then
    :meth:`print_model_profile` and the accessors, as the JAX profiler. The
    engine drives it at ``flops_profiler.profile_step``. ``flops`` is
    2 × ``macs``: the counted matmul and convolution flops."""

    def __init__(self, model=None, ds_engine=None, recompute_fwd_factor: float = 0.0):
        self.model = model
        self.ds_engine = ds_engine
        self.recompute_fwd_factor = recompute_fwd_factor
        self.started = False
        self.flops = 0.0
        self.macs = 0
        self.params = 0
        self.per_scope: Dict[str, int] = {}
        self.duration = 0.0
        self._counter: Optional[FlopCounter] = None
        self._scopes = None

    def start_profile(self, ignore_list=None):
        self._counter = FlopCounter(self.model)
        self._scopes = self._counter.scoped()
        self._scopes.__enter__()
        self._counter.__enter__()
        self.started = True

    def stop_profile(self):
        if not self.started:
            return
        try:
            self._counter.__exit__(None, None, None)
        finally:
            self._scopes.__exit__(None, None, None)
            self.started = False
        c = self._counter
        self.flops = float(c.total)
        self.macs = c.total // 2
        self.per_scope = dict(c.per_scope)

    def profile_fn(self, fn: Callable, *args, params=None, duration: float = 0.0, **kwargs):
        """Run ``fn(*args, **kwargs)`` under the counter; → self."""
        self.start_profile()
        try:
            fn(*args, **kwargs)
        finally:
            self.stop_profile()
        self.duration = duration
        if params is not None:
            self.params = _count_params(params)
        return self

    def reset_profile(self):
        self.flops = 0.0
        self.macs = 0
        self.params = 0
        self.per_scope = {}

    def end_profile(self):
        self.stop_profile()
        self.reset_profile()

    def get_total_flops(self, as_string=False):
        return flops_to_string(self.flops) if as_string else self.flops

    def get_total_macs(self, as_string=False):
        return macs_to_string(self.macs) if as_string else self.macs

    def get_total_params(self, as_string=False):
        return params_to_string(self.params) if as_string else self.params

    def get_total_duration(self, as_string=False):
        return duration_to_string(self.duration) if as_string else self.duration

    def print_model_profile(self, profile_step=1, module_depth=-1, top_modules=1,
                            detailed=True, output_file=None):
        out = open(output_file, "w") if output_file else sys.stdout
        try:
            print("\n------------------------- DeepSpeed-Torch Flops Profiler "
                  "-------------------------", file=out)
            print(f"Profile step:                   {profile_step}", file=out)
            print(f"Params:                         {params_to_string(self.params)}", file=out)
            print(f"MACs (matmul/conv):             {macs_to_string(self.macs)}", file=out)
            print(f"FLOPs (2 x MACs):               {flops_to_string(self.flops)}", file=out)
            print("  (no compiled-program flop or byte count on CUDA: XLA's cost analysis "
                  "has no counterpart)", file=out)
            if self.duration > 0:
                print(f"Step latency:                   {duration_to_string(self.duration)}",
                      file=out)
                print(f"Achieved:                       "
                      f"{flops_to_string(self.flops / self.duration)}", file=out)
            if detailed and self.per_scope:
                print("Per-scope matmul/conv flops:", file=out)
                ranked = sorted(self.per_scope.items(), key=lambda kv: -kv[1])
                for name, f in ranked[:max(top_modules, 1)]:
                    print(f"  {name or '<toplevel>':48s} {flops_to_string(f)}", file=out)
            print("--------------------------------------------------------------"
                  "-----------------\n", file=out)
        finally:
            if output_file:
                out.close()


def get_model_profile(model=None,
                      fn: Callable = None,
                      args=(),
                      kwargs=None,
                      params=None,
                      print_profile=True,
                      detailed=True,
                      module_depth=-1,
                      top_modules=1,
                      warm_up=1,
                      as_string=True,
                      output_file=None,
                      ignore_modules=None):
    """Profile one forward, ``fn(*args, **kwargs)`` (default
    ``model.apply``, else the model's call), run without gradients.
    → (flops, macs, params), strings with ``as_string``; params counts
    ``params`` (tensors, nested dicts or lists of them, or a module) when
    given. ``warm_up``, ``module_depth`` and ``ignore_modules`` are taken
    and change nothing, as in JAX."""
    kwargs = kwargs or {}
    if fn is None:
        if model is None:
            raise ValueError("get_model_profile: pass fn= or a model")
        # the port's models define apply(input_ids) over nn.Module's apply(fn)
        fn = model.apply if type(model).apply is not torch.nn.Module.apply else model
    prof = FlopsProfiler(model)
    with torch.no_grad():
        prof.profile_fn(fn, *args, params=params, **kwargs)
    if print_profile:
        prof.print_model_profile(detailed=detailed, module_depth=module_depth,
                                 top_modules=top_modules, output_file=output_file)
    if as_string:
        return (prof.get_total_flops(True), prof.get_total_macs(True),
                prof.get_total_params(True))
    return prof.flops, prof.macs, prof.params
