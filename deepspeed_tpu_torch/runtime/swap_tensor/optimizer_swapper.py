"""NVMe-swapped Adam: ZeRO-Infinity's optimizer state on disk.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor/optimizer_swapper.py``
(the reference's ``partitioned_optimizer_swapper.py`` with CPU Adam): the
fp32 masters and both Adam moments live in files, three per named tensor
(``<name>#w``, ``#m``, ``#v``); the engine names one per ZeRO unit, this
rank's part of a module's parameters laid end to end. Each step streams
them through host memory in windows of ``buffer_count`` tensors, issuing
the next window's reads before the current window's update, applies AdamW
on the host with torch CPU ops (``adam_leaf_update``, the engine's own
rule) and writes them back. The card holds only the compute-type params and
the gradients.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping, Optional

import torch

from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
from deepspeed_tpu_torch.ops.optimizers import adam_bias_corrections, adam_leaf_update
from deepspeed_tpu_torch.runtime.swap_tensor.partition_swapper import AsyncTensorSwapper
from deepspeed_tpu_torch.utils.logging import logger

KINDS = ("w", "m", "v")      # master, first moment, second moment


def _windows(names: List[str], size: int) -> List[List[str]]:
    size = max(1, size)
    return [names[i:i + size] for i in range(0, len(names), size)]


class SwappedOptimizer:
    """Adam/AdamW with its state on disk, window-pipelined with async I/O.
    The hyperparameters follow the JAX package's swapped optimizer:
    ``adam_w_mode`` for ``adamw``, or for ``adam`` when its params say so."""

    def __init__(self, swap_folder: str, optimizer_name: str = "adamw",
                 optimizer_params: Optional[dict] = None,
                 aio_config: Optional[dict] = None, buffer_count: int = 4):
        name = optimizer_name.lower()
        if name not in ("adam", "adamw"):
            raise ValueError(f"NVMe offload supports adam/adamw, got {optimizer_name!r} "
                             "(the reference swaps Adam state too)")
        p = dict(optimizer_params or {})
        self.lr = float(p.get("lr", 1e-3))
        betas = p.get("betas", (0.9, 0.999))
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(p.get("eps", 1e-8))
        self.weight_decay = float(p.get("weight_decay", 0.0))
        self.adam_w_mode = name == "adamw" or bool(p.get("adam_w_mode", False))
        self.buffer_count = buffer_count
        self.swapper = AsyncTensorSwapper(swap_folder, aio_config)
        self.step_count = 0
        self._names: List[str] = []

    # ------------------------------------------------------------------ init
    def init_from_params(self, named_params: Mapping[str, torch.Tensor]) -> None:
        """Write the initial fp32 masters and zero moments, a window at a
        time, so init holds no more host memory than a step."""
        self._names = list(named_params)
        for window in _windows(self._names, self.buffer_count):
            for name in window:
                self.add_tensor(name, named_params[name], release=False)
            self.swapper.synchronize()
            for name in window:
                for k in KINDS:
                    self.swapper.release(f"{name}#{k}")
        total = sum(t.numel() for t in named_params.values())
        logger.info(f"SwappedOptimizer: {len(self._names)} tensors, "
                    f"{total * 12 / 2**30:.2f} GiB optimizer state on {self.swapper.swap_folder}")

    def add_tensor(self, name: str, master: torch.Tensor, release: bool = True) -> None:
        """Write one tensor's fp32 master and zero moments (a tensor added
        after the others is stepped after them)."""
        master = master.detach().to("cpu", torch.float32)
        if name not in self._names:
            self._names.append(name)
        self.swapper.swap_out(f"{name}#w", master)
        zeros = torch.zeros_like(master)
        self.swapper.swap_out(f"{name}#m", zeros)
        self.swapper.swap_out(f"{name}#v", zeros)
        if release:
            for k in KINDS:
                self.swapper.release(f"{name}#{k}")

    # ---------------------------------------------------- single tensors
    def read(self, name: str, kind: str) -> torch.Tensor:
        """A copy of one tensor's master (``w``) or moment (``m``, ``v``)."""
        key = f"{name}#{kind}"
        self.swapper.swap_in(key, async_op=False)
        out = self.swapper.retrieve(key).clone()
        self.swapper.release(key)
        return out

    def write(self, name: str, kind: str, value: torch.Tensor) -> None:
        key = f"{name}#{kind}"
        self.swapper.swap_out(key, value.detach().to("cpu", torch.float32), async_op=False)
        self.swapper.release(key)

    def _issue_reads(self, window: Iterable[str]) -> None:
        for name in window:
            for k in KINDS:
                self.swapper.swap_in(f"{name}#{k}", async_op=True)

    # ------------------------------------------------------------------ step
    @torch.no_grad()
    def step(self, named_grads: Mapping[str, torch.Tensor], lr: Optional[float] = None,
             grad_scale: float = 1.0,
             on_update: Optional[Callable[[str, torch.Tensor], None]] = None
             ) -> Optional[Dict[str, torch.Tensor]]:
        """One Adam step over every tensor. ``grad_scale`` multiplies the
        gradients first (the caller's global-norm clip). Each tensor's new
        fp32 master goes to ``on_update(name, master)`` while its window is
        in memory (the tensor is valid during the call), or, without it,
        into the returned dict of copies. ``named_grads`` is read one name
        at a time, in window order."""
        if not self._names:
            raise RuntimeError("call init_from_params first")
        missing = [n for n in self._names if n not in named_grads]
        if missing:
            raise KeyError(f"grads missing for {missing[:3]}...")
        lr = self.lr if lr is None else float(lr)
        self.step_count += 1
        bc1, bc2 = adam_bias_corrections(self.step_count, self.b1, self.b2)

        out: Dict[str, torch.Tensor] = {}
        windows = _windows(self._names, self.buffer_count)
        self._issue_reads(windows[0])
        self.swapper.synchronize()
        for wi, window in enumerate(windows):
            # this window's reads are done: start the next window's, so the
            # disk works while this one is updated
            views = {n: {k: self.swapper.retrieve(f"{n}#{k}") for k in KINDS} for n in window}
            if wi + 1 < len(windows):
                self._issue_reads(windows[wi + 1])
            for name in window:
                g = named_grads[name].to("cpu", torch.float32)
                if grad_scale != 1.0:
                    g = g * grad_scale
                w, m, v = (views[name][k] for k in KINDS)
                adam_leaf_update(w, m, v, g, lr, self.b1, self.b2, self.eps,
                                 self.weight_decay, self.adam_w_mode, bc1, bc2)
                if on_update is None:
                    out[name] = w.clone()
                else:
                    on_update(name, w)
                for k in KINDS:
                    self.swapper.swap_out(f"{name}#{k}", views[name][k])
            self.swapper.synchronize()
            for name in window:
                for k in KINDS:
                    self.swapper.release(f"{name}#{k}")
        return out if on_update is None else None

    def state_bytes(self) -> int:
        return sum(max(0, AsyncIOHandle.file_size(self.swapper._path(f"{n}#{k}")))
                   for n in self._names for k in KINDS)


class SwapUnits:
    """One kind of a :class:`SwappedOptimizer`'s tensors (``w``, ``m`` or
    ``v``) as a per-unit list the engine's ZeRO state reads and writes:
    ``units[u]`` reads tensor ``names[u]`` from disk (a copy), and
    ``write_unit(u, t)`` writes it; a checkpoint moves one unit at a time."""

    def __init__(self, optimizer: SwappedOptimizer, names: List[str], kind: str):
        self.optimizer, self.names, self.kind = optimizer, list(names), kind

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, u: int) -> torch.Tensor:
        return self.optimizer.read(self.names[u], self.kind)

    def write_unit(self, u: int, value: torch.Tensor) -> None:
        self.optimizer.write(self.names[u], self.kind, value)
