"""ZeRO-Infinity: parameters and optimizer state on NVMe, layerwise execution.

Counterpart of ``deepspeed_tpu/runtime/zero/infinity.py`` (the reference's
``partitioned_param_swapper.py`` with ``remote_device='nvme'``). The
training step is driven by the host one layer at a time:

  forward:  embedding → [layer l's weights read from NVMe → one block] × L,
            each block's input parked in host memory
  loss:     final norm + chunked loss, and its gradients for the top-level
            weights and the last block's output
  backward: in reverse, [layer l's weights read again → the block recomputed
            from its parked input → its gradients] × L, each layer's
            gradients landing in host memory; then the embedding's
  step:     global-norm clip, then the windowed NVMe AdamW
            (``swap_tensor/optimizer_swapper.py``) over every tensor on disk;
            only the top-level weights come back to the card.

The card holds one layer's weights in the compute type, the top-level
weights in fp32, one activation and one block's autograd graph: a model
whose parameters exceed the card trains. Host memory holds the parked
activations and the gradients; the disk moves the weights twice per
microbatch and the optimizer state once each way per step.

It drives ``GPT2Model`` through its stages (``embed_stage``, ``_block``,
``loss_stage``), where the JAX engine takes them from the pipeline model;
the model's own parameters are only read at init (its weights, or its
``param_chunks`` draws when they are not loaded) and written to disk one
tensor at a time, under the JAX package's names (``layer<l>/<key>``,
``shared/<name>``).

Checkpoints go through the port's verified checkpoint engine
(``runtime/checkpoint_engine/engine.py``) in the tag layout every engine of
the port writes: the flat state's keys are the model's parameter names
(``params/``, ``master/`` in a compute type other than fp32,
``opt_state/{count,mu,nu}``), read from the NVMe files one tensor at a time,
so a tag of this engine loads into ``DeepSpeedEngine`` at any placement and
the other way round.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import types
from typing import Any, Dict, List, Mapping

import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.models.gpt2 import BLOCK_KEYS
from deepspeed_tpu_torch.models.common import parse_lm_batch
from deepspeed_tpu_torch.utils.logging import log_dist


class ZeroInfinityEngine:
    """Layerwise trainer with the params and the Adam state on NVMe."""

    def __init__(self, model, ds_config, device=None):
        from deepspeed_tpu_torch import comm
        from deepspeed_tpu_torch.models.gpt2 import GPT2Model
        from deepspeed_tpu_torch.runtime.lr_schedules import build_lr_schedule
        from deepspeed_tpu_torch.runtime.swap_tensor.optimizer_swapper import SwappedOptimizer

        if not isinstance(model, GPT2Model):
            raise NotImplementedError("ZeRO-Infinity param offload drives GPT2Model's stages; "
                                      f"got {type(model).__name__}")
        if comm.is_initialized() and comm.get_world_size() > 1:
            raise NotImplementedError("layerwise param-NVMe runs on one process; train over "
                                      "many with offload_optimizer nvme instead")
        self.model = self.module = model
        self.config = model.config
        self.device = resolve_device(device)
        self._config = ds_config
        ds_config._configure_train_batch_size(1)
        off = ds_config.zero_config.offload_param
        folder = off.nvme_path or os.path.join(tempfile.gettempdir(), "ds_tpu_nvme_params")
        opt_params = dict(ds_config.optimizer_params or {})
        self.optimizer = SwappedOptimizer(
            swap_folder=folder, optimizer_name=ds_config.optimizer_name or "adamw",
            optimizer_params=opt_params, aio_config=dataclasses.asdict(ds_config.aio_config),
            buffer_count=off.buffer_count)
        self._lr = float(opt_params.get("lr", 1e-3))
        self.lr_scheduler = build_lr_schedule(ds_config.scheduler_name,
                                              dict(ds_config.scheduler_params or {})) \
            if ds_config.scheduler_name else None
        self.gas = int(ds_config.gradient_accumulation_steps or 1)
        self.grad_clip = float(ds_config.gradient_clipping or 0.0)
        # the counters the checkpoint engine saves and restores
        self.global_steps = self.global_samples = self.micro_steps = self.skipped_steps = 0
        self.zero_stage = ds_config.zero_optimization_stage
        self.dp_world_size = 1
        self._keep_master = model.config.dtype != torch.float32
        self._last_save = self._last_recovery = None
        self.shared: Dict[str, torch.Tensor] = {}
        model.param_gatherer = None

        # the masters and moments written to disk a tensor at a time: the
        # card and the host hold one tensor beyond the top-level weights
        shapes = {n: p.shape for n, p in model.named_parameters()}
        if any(p.is_meta for p in model.parameters()):
            gen = torch.Generator(device=self.device).manual_seed(ds_config.seed)
            tensors = self._assembled(model.param_chunks(gen), shapes)
        else:
            tensors = ((n, p.detach()) for n, p in model.named_parameters())
        n_elems = 0
        for name, t in tensors:
            n_elems += t.numel()
            if not name.startswith("blocks."):
                self.shared[name] = t.to(self.device, torch.float32, copy=True)
            self.optimizer.add_tensor(self._swap_name(name), t)
        log_dist(f"ZeRO-Infinity: {n_elems / 1e6:.1f}M params and their Adam state on NVMe "
                 f"({folder}); layerwise execution, one layer on the card", ranks=[0])

    @staticmethod
    def _assembled(chunks, shapes):
        """Whole tensors ``(name, fp32 tensor)`` from ``param_chunks``
        pieces, each yielded as soon as its last piece arrived."""
        name = buf = None
        for n, start, values in chunks:
            if n != name:
                name, buf = n, torch.empty(shapes[n], device=values.device)
            buf.view(-1)[start:start + values.numel()] = values
            if start + values.numel() == buf.numel():
                yield name, buf

    # --------------------------------------------------------------- helpers
    @staticmethod
    def _swap_name(name: str) -> str:
        """A model parameter's name on disk, the JAX package's."""
        if name.startswith("blocks."):
            _, layer, key = name.split(".")
            return f"layer{int(layer):03d}/{key}"
        return f"shared/{name}"

    def _read_layer(self, l: int, grad: bool = False) -> types.SimpleNamespace:
        """Layer l's weights in the compute type on the card, read from the
        NVMe masters (leaves of autograd when ``grad``)."""
        sw = self.optimizer.swapper
        names = [f"layer{l:03d}/{k}#w" for k in BLOCK_KEYS]
        for n in names:
            sw.swap_in(n, async_op=True)
        sw.synchronize()
        out = {}
        for k, n in zip(BLOCK_KEYS, names):
            out[k] = sw.retrieve(n).to(self.device, self.config.dtype).requires_grad_(grad)
            sw.release(n)
        return types.SimpleNamespace(**out)

    def _to_device(self, batch):
        put = lambda x: torch.as_tensor(x).to(self.device)
        if isinstance(batch, dict):
            return {k: put(v) for k, v in batch.items()}
        return put(batch)

    # ------------------------------------------------------------ train step
    def train_batch(self, batch=None, data_iter=None) -> torch.Tensor:
        """One step over the global batch (all microbatches); the mean loss."""
        if batch is None:
            batch = next(data_iter)
        m = self.model
        batch = self._to_device(batch)
        ids, _, _ = parse_lm_batch(batch)
        rows = ids.shape[0]
        if rows % self.gas:
            raise ValueError(f"batch rows {rows} not divisible by gradient_accumulation_steps "
                             f"{self.gas}")
        per = rows // self.gas
        L = self.config.n_layer
        grads: Dict[str, torch.Tensor] = {}
        losses: List[float] = []

        def add(key, g):
            g = g.detach().to("cpu", torch.float32)
            grads[key] = g if key not in grads else grads[key] + g

        for g in range(self.gas):
            sl = slice(g * per, (g + 1) * per)
            mb = {k: v[sl] for k, v in batch.items()} if isinstance(batch, dict) else batch[sl]
            mids, _, _ = parse_lm_batch(mb)
            top = types.SimpleNamespace(**{n: v.detach().requires_grad_()
                                           for n, v in self.shared.items()})
            # forward: the block inputs parked on the host
            acts = []
            with torch.no_grad():
                x = m.embed_stage(top, mids)
                for l in range(L):
                    blk = self._read_layer(l)
                    acts.append(x.to("cpu"))
                    x = m._block(x, blk)
            # loss, and the gradients of the top-level weights and of x
            x = x.detach().requires_grad_()
            loss = m.loss_stage(top, x, mb)
            loss.backward()
            losses.append(float(loss.detach()))
            dx = x.grad
            # backward, a layer at a time from its parked input
            for l in reversed(range(L)):
                blk = self._read_layer(l, grad=True)
                x_l = acts.pop().to(self.device).requires_grad_()
                m._block(x_l, blk).backward(dx)
                dx = x_l.grad
                for k in BLOCK_KEYS:
                    add(f"layer{l:03d}/{k}", getattr(blk, k).grad)
            m.embed_stage(top, mids).backward(dx)
            for n in self.shared:
                add(f"shared/{n}", getattr(top, n).grad)
        if self.gas > 1:
            grads = {k: v / self.gas for k, v in grads.items()}
        loss = torch.tensor(sum(losses) / len(losses), dtype=torch.float32)

        # global-norm clip and the windowed NVMe AdamW over every tensor
        gnorm = float(sum(float(g.square().sum()) for g in grads.values())) ** 0.5
        scale = self.grad_clip / (gnorm + 1e-6) \
            if self.grad_clip > 0 and gnorm > self.grad_clip else 1.0
        lr = float(self.lr_scheduler.lr_at(self.global_steps)) \
            if self.lr_scheduler is not None else self._lr

        def refresh(name, master):
            if name.startswith("shared/"):
                self.shared[name[len("shared/"):]].copy_(master)

        self.optimizer.step(grads, lr=lr, grad_scale=scale, on_update=refresh)
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        self.global_steps += 1
        self.global_samples += rows
        self.micro_steps += self.gas
        self.last_grad_norm = gnorm
        return loss

    def train_batch_size(self) -> int:
        return int(self._config.train_batch_size)

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, save_dir: str, tag=None, client_state=None,
                        save_latest: bool = True) -> bool:
        from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import \
            save_engine_checkpoint

        return save_engine_checkpoint(self, save_dir, tag=tag, client_state=client_state,
                                      save_latest=save_latest)

    def load_checkpoint(self, load_dir: str, tag=None, load_optimizer_states: bool = True,
                        load_module_only: bool = False, **_):
        from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import \
            load_engine_checkpoint

        return load_engine_checkpoint(self, load_dir, tag=tag,
                                      load_optimizer_states=load_optimizer_states,
                                      load_module_only=load_module_only)

    def _names(self) -> List[str]:
        return [n for n, _ in self.model.named_parameters()]

    def flat_state_shapes(self) -> Dict[str, tuple]:
        """The keys of :meth:`flat_state` and their shapes."""
        shapes = {n: tuple(p.shape) for n, p in self.model.named_parameters()}
        out = {"step": ()}
        out.update({f"params/{n}": s for n, s in shapes.items()})
        if self._keep_master:
            out.update({f"master/{n}": s for n, s in shapes.items()})
        out["opt_state/count"] = ()
        for field in ("mu", "nu"):
            out.update({f"opt_state/{field}/{n}": s for n, s in shapes.items()})
        out["skipped_steps"] = ()
        return out

    def flat_state(self) -> Dict[str, torch.Tensor]:
        """The training state under the flat keys every engine of the port
        saves (``checkpoint_engine.flatten_state``'s), whole tensors on the
        host, read from the NVMe files one tensor at a time: the params in
        the compute type cast from the masters, the masters, AdamW's
        moments as ``mu``/``nu``."""
        read = self.optimizer.read
        self.optimizer.swapper.synchronize()
        names = self._names()
        out = {"step": torch.tensor(self.global_steps, dtype=torch.int64)}
        masters = {n: read(self._swap_name(n), "w") for n in names}
        out.update({f"params/{n}": m.to(self.config.dtype) for n, m in masters.items()})
        if self._keep_master:
            out.update({f"master/{n}": m for n, m in masters.items()})
        del masters
        out["opt_state/count"] = torch.tensor(self.optimizer.step_count, dtype=torch.int64)
        for field, kind in (("mu", "m"), ("nu", "v")):
            out.update({f"opt_state/{field}/{n}": read(self._swap_name(n), kind)
                        for n in names})
        out["skipped_steps"] = torch.tensor(self.skipped_steps, dtype=torch.int64)
        return out

    @torch.no_grad()
    def apply_flat_state(self, flat: Mapping[str, torch.Tensor], load_module_only: bool = False,
                         load_optimizer_states: bool = True) -> None:
        """A flat state of whole tensors into the NVMe files and the
        top-level weights, one tensor at a time, by the rules of
        ``checkpoint_engine.apply_flat_state``: the masters from ``master/``
        (from ``params/`` in fp32 or under ``load_module_only``); the
        moments and counters unless ``load_module_only`` or not
        ``load_optimizer_states``."""
        use_params = load_module_only or not self._keep_master
        for n in self._names():
            master = flat[f"{'params' if use_params else 'master'}/{n}"].float()
            self.optimizer.write(self._swap_name(n), "w", master)
            if n in self.shared:
                self.shared[n].copy_(master)
        if load_module_only or not load_optimizer_states:
            return
        for n in self._names():
            self.optimizer.write(self._swap_name(n), "m", flat[f"opt_state/mu/{n}"])
            self.optimizer.write(self._swap_name(n), "v", flat[f"opt_state/nu/{n}"])
        self.optimizer.step_count = int(flat["opt_state/count"])
        self.global_steps = int(flat["step"])
        self.skipped_steps = int(flat["skipped_steps"])

    # -------------------------------------------------- full-tree export
    def gather_params(self) -> Dict[str, Any]:
        """The whole fp32 tree on the host, in the JAX package's layout
        (``blocks`` stacked (L, ...)); for models that fit."""
        layers = [{k: self.optimizer.read(f"layer{l:03d}/{k}", "w") for k in BLOCK_KEYS}
                  for l in range(self.config.n_layer)]
        out: Dict[str, Any] = {n: v.detach().cpu() for n, v in self.shared.items()}
        out["blocks"] = {k: torch.stack([layer[k] for layer in layers]) for k in BLOCK_KEYS}
        return out
