"""ZeRO-Offload: optimizer state in host memory, streamed through the card.

Counterpart of the offload pieces of ``deepspeed_tpu/runtime/engine.py``
(the policy at ``:343-413``, the whole-tree stream-in at ``:1003-1044``,
``_apply_grads_streamed_adam`` at ``:1092``). As there, the card still does
the optimizer's math (the reference steps a CPU Adam instead): host memory
holds the state, and each step moves it to the card and back.

Host memory is pinned on a CUDA engine (``ops/aio.host_zeros``, the
counterpart of the JAX ``pinned_host`` memory kind): each unit's tensor is
pages of its own, its size rounded up to a page, registered with
``cudaHostRegister``; never one block for the whole state, and never the
caching host allocator, which rounds every block up to a power of two. A
tensor that cannot be pinned raises. On a CPU engine the host is the same
memory: the state is held in other CPU tensors and every copy is a CPU
copy, so the CPU tests run the same code path.

:class:`HostOffload` runs the update, per ZeRO unit (one module's
parameters, flat; the rank's part of it):

- whole-tree (the JAX package's path when the state fits): every host
  tensor of the optimizer state (and the fp32 master when it is on the
  host) copied to the card, the optimizer's own ``update``, the params
  refreshed, the state copied back;
- streamed (Adam only, when it does not fit): each unit in chunks of
  ``DS_TPU_OFFLOAD_CHUNK_BYTES`` fp32 bytes; a chunk's master and moments
  copied in on a copy stream, ``adam_leaf_update`` on the compute stream,
  the chunk's compute-type params written from the new master on the card,
  and the chunk copied back on a second copy stream. Events order the three
  streams: serially by default (a chunk's copy in waits for the previous
  chunk's copy back: one working set on the card), or, with
  ``stream_overlap``, with two working sets (a chunk's copy in waits for
  the copy back of the chunk two before it). The update never synchronizes
  the host; the compute stream waits for the last copy back before the
  working sets are freed, and every later reader of the host state is on
  the compute stream or synchronizes first (``ZeroState.host_sync``).
"""

from __future__ import annotations

import contextlib
import os
from typing import List, Optional

import torch

from deepspeed_tpu_torch.ops.aio import host_zeros
from deepspeed_tpu_torch.ops.optimizers import Optimizer, adam_bias_corrections, adam_leaf_update

CHUNK_BYTES = 256 << 20          # DS_TPU_OFFLOAD_CHUNK_BYTES default, fp32 bytes per chunk


def env_flag(name: str) -> bool:
    """A boolean environment knob: unset, empty, "0", "false", "no" and
    "off" are off (the JAX package's ``utils.env_flag``)."""
    return os.environ.get(name, "").strip().lower() not in ("", "0", "false", "no", "off")


def host_opt_state(optimizer: Optimizer, numels: List[int], pin: bool):
    """The optimizer's state for units of ``numels`` fp32 elements with its
    tensors in host memory, each on pages of its own (pinned when ``pin``)
    and filled with the value the rule starts it at, read from the state of
    a one-element probe (every rule here starts each state tensor at one
    value: zeros, or Adagrad's ``initial_accumulator_value``)."""
    probe = optimizer.init([torch.empty(1, dtype=torch.float32)])
    fields = {}
    for f, v in probe._asdict().items():
        if isinstance(v, list):
            start = v[0].item()
            fields[f] = [host_zeros(n, v[0].dtype, pin) for n in numels]
            if start:
                for t in fields[f]:
                    t.fill_(start)
    return probe._replace(**fields)


class _Streams:
    """The copy-in and copy-back streams of a CUDA engine; on the CPU every
    method is a no-op and copies run in order."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.h2d = torch.cuda.Stream(device)
            self.d2h = torch.cuda.Stream(device)

    def on(self, name: str):
        return torch.cuda.stream(getattr(self, name)) if self.cuda else contextlib.nullcontext()

    def record(self, name: Optional[str] = None):
        """An event at the end of the work queued so far on ``name`` (the
        current stream when None)."""
        if not self.cuda:
            return None
        stream = getattr(self, name) if name else torch.cuda.current_stream()
        return stream.record_event()

    def wait(self, event, name: Optional[str] = None) -> None:
        if event is not None:
            (getattr(self, name) if name else torch.cuda.current_stream()).wait_event(event)

    def wait_stream(self, waiter: Optional[str], waited: Optional[str]) -> None:
        if self.cuda:
            get = lambda n: getattr(self, n) if n else torch.cuda.current_stream()
            get(waiter).wait_stream(get(waited))


class HostOffload:
    """The offloaded update of one engine's ZeRO state ``zero``: the
    optimizer state's tensors in host memory, and ``zero.fp32`` on the host
    too when ``master_host``. ``streamed``: chunked Adam (else whole-tree);
    ``overlap``: two working sets; ``chunk_bytes``: fp32 bytes per chunk."""

    def __init__(self, zero, master_host: bool, streamed: bool, overlap: bool,
                 chunk_bytes: int = CHUNK_BYTES):
        self.zero = zero
        self.device = zero.device
        self.master_host = master_host
        self.streamed = streamed
        self.overlap = overlap
        # a multiple of 64 elements, so every chunk's views stay aligned
        self.chunk = max(64, chunk_bytes // 4 // 64 * 64)
        self.streams = _Streams(self.device)
        self.h2d_bytes = self.d2h_bytes = 0       # moved by the last update

    @torch.no_grad()
    def update(self, optimizer: Optimizer, grads, state, lr: float, **flat):
        """One optimizer step on the host state; the params refreshed.
        Returns the new state, its tensors the same host tensors."""
        self.h2d_bytes = self.d2h_bytes = 0
        if self.streamed and optimizer.hyper is not None:
            return self._streamed_adam(optimizer.hyper, grads, state, lr)
        return self._whole(optimizer, grads, state, lr, **flat)

    def _whole(self, optimizer, grads, state, lr, **flat):
        z, s = self.zero, self.streams
        host = {f: v for f, v in state._asdict().items() if isinstance(v, list)}
        on_card = lambda ts: [torch.empty_like(t, device=self.device) for t in ts]
        dev = {f: on_card(v) for f, v in host.items()}
        fp32 = on_card(z.fp32) if self.master_host else z.fp32
        s.wait_stream("h2d", None)                 # the buffers' memory is free
        with s.on("h2d"):
            for f in host:
                for d, h in zip(dev[f], host[f]):
                    d.copy_(h, non_blocking=True)
            if self.master_host:
                for d, h in zip(fp32, z.fp32):
                    d.copy_(h, non_blocking=True)
            arrived = s.record("h2d")
        s.wait(arrived)
        new = optimizer.update(grads, state._replace(**dev), fp32, lr=lr, **flat)
        z.refresh_params(fp32)
        done = s.record()
        with s.on("d2h"):
            s.wait(done, "d2h")
            for f in host:
                for h, d in zip(host[f], getattr(new, f)):
                    h.copy_(d, non_blocking=True)
            if self.master_host:
                for h, d in zip(z.fp32, fp32):
                    h.copy_(d, non_blocking=True)
        s.wait_stream(None, "d2h")                 # before the card copies are freed
        moved = sum(t.numel() * 4 for v in host.values() for t in v) \
            + (sum(t.numel() * 4 for t in z.fp32) if self.master_host else 0)
        self.h2d_bytes = self.d2h_bytes = moved
        return new._replace(**host)

    def _streamed_adam(self, h: dict, grads, state, lr):
        z, s = self.zero, self.streams
        count = state.count + 1
        bc1, bc2 = adam_bias_corrections(count, h["b1"], h["b2"], h["bias_correction"])
        chunk, sets = self.chunk, 2 if self.overlap else 1

        def working_set():
            ws = {k: torch.empty(chunk, dtype=torch.float32, device=self.device)
                  for k in (("m", "mu", "nu") if self.master_host else ("mu", "nu"))}
            ws["p"] = torch.empty(chunk, dtype=z.dtype, device=self.device)
            return ws

        work = [working_set() for _ in range(sets)]
        freed = [None] * sets                     # each set's last copy back
        s.wait_stream("h2d", None)
        k = 0
        for u in range(len(z.fp32)):
            n = z.fp32[u].numel()
            slot = z.param_slot(u)                # the params laid out as fp32[u]
            staging = torch.empty(n, dtype=z.dtype, device=self.device) if slot is None \
                else None
            dst = slot if slot is not None else staging
            for lo in range(0, n, chunk):
                hi = min(n, lo + chunk)
                c, ws = hi - lo, work[k % sets]
                with s.on("h2d"):
                    s.wait(freed[k % sets], "h2d")
                    m = ws["m"][:c].copy_(z.fp32[u][lo:hi], non_blocking=True) \
                        if self.master_host else z.fp32[u][lo:hi]
                    mu = ws["mu"][:c].copy_(state.mu[u][lo:hi], non_blocking=True)
                    nu = ws["nu"][:c].copy_(state.nu[u][lo:hi], non_blocking=True)
                    arrived = s.record("h2d")
                s.wait(arrived)
                adam_leaf_update(m, mu, nu, grads[u][lo:hi], lr, h["b1"], h["b2"], h["eps"],
                                 h["weight_decay"], h["adam_w_mode"], bc1, bc2)
                p_host = dst.device.type != self.device.type
                (ws["p"][:c] if p_host else dst[lo:hi]).copy_(m)
                done = s.record()
                with s.on("d2h"):
                    s.wait(done, "d2h")
                    if self.master_host:
                        z.fp32[u][lo:hi].copy_(m, non_blocking=True)
                    state.mu[u][lo:hi].copy_(mu, non_blocking=True)
                    state.nu[u][lo:hi].copy_(nu, non_blocking=True)
                    if p_host:
                        dst[lo:hi].copy_(ws["p"][:c], non_blocking=True)
                    freed[k % sets] = s.record("d2h")
                k += 1
                moved = c * 4 * (3 if self.master_host else 2)
                self.h2d_bytes += moved
                self.d2h_bytes += moved + (c * dst.element_size() if p_host else 0)
            if staging is not None:
                z.store_params(u, staging)
        s.wait_stream(None, "d2h")                 # before the working sets are freed
        return state._replace(count=count)
