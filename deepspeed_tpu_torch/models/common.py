"""Shared model building blocks: RoPE, ALiBi, the attention dispatch, the
LM loss, the remat policies, and what every model needs to train under the
engine.

Counterpart of ``deepspeed_tpu/models/common.py`` for what the llama, GPT-2
and BERT paths use. The attention dispatch has no fallback: ``use_flash`` /
``use_flash_decode`` choose the kernel wrapper (which launches the CUDA
kernel for a CUDA tensor and runs its plain version for a CPU tensor),
otherwise the plain einsum path runs, as the JAX package's flags select. A
``key_padding_mask``, ALiBi slopes or a GPT-Neo window (> 0) always take the
plain path, as in JAX (the kernels carry no mask or bias); the choice is
made per call, on the host. Where the JAX dispatch catches a failing flash
kernel and falls back to einsum, the port raises.

:func:`remat_call` runs a block under the configured activation-checkpoint
policy: "full" keeps nothing, "dots" keeps the outputs of the matmuls
without batch dimensions, "attn" the flash forward's outputs (its op,
``ds_tpu_torch::flash_fwd``), "attn_mlp" those and the MLP activation
(``checkpoint_name("mlp_act")``), as the JAX policies of the same names.

:class:`GatheredModule` is the base of the models the engine trains: each
module computes with its own parameters through ``_gathered(module)``,
which ZeRO stage 3 and ``offload_param`` redirect to gathered copies
(``param_gatherer``). :func:`meta_weight`, :func:`init_pieces` and
:func:`assemble` are the models' shared parameter plumbing: parameters that
hold no memory until filled, random initial values drawn a piece at a time
(``param_chunks``), and the whole tree assembled from those pieces.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from deepspeed_tpu_torch.ops.pallas.decode_attention import decode_attention, decode_reference
from deepspeed_tpu_torch.ops.pallas.flash_attention import flash_attention, mha_reference
from deepspeed_tpu_torch.runtime.progressive_layer_drop import layer_keep_probs

# logits-buffer budget: chunk length chosen so the (B, chunk, V) fp32 buffer
# stays around 256MB (the JAX package's value)
_CHUNK_ELEMS = 64 * 1024 * 1024

# elements per piece of a random initial tensor (``param_chunks``)
INIT_CHUNK = 1 << 24


def meta_weight(*shape) -> nn.Parameter:
    """A trainable parameter on the meta device: a model holds no memory
    until init_params, params_from_jax or load_state_dict(assign=True) fills
    it."""
    return nn.Parameter(torch.empty(*shape, device="meta"))


def init_pieces(generator: torch.Generator, chunk: Optional[int] = None):
    """``pieces(name, shape, scale=None, fill=0.0)``: the ``(name, start,
    values)`` pieces of one random initial tensor, at most ``chunk``
    (``INIT_CHUNK``) elements each, in order: normal draws from
    ``generator`` times ``scale`` on its device, or ``fill`` without a
    scale."""
    dev = generator.device
    chunk = chunk or INIT_CHUNK

    def pieces(name, shape, scale=None, fill=0.0):
        n = math.prod(shape)
        for start in range(0, n, chunk):
            m = min(chunk, n - start)
            yield name, start, (torch.randn(m, generator=generator, device=dev).mul_(scale)
                                if scale is not None
                                else torch.full((m,), fill, device=dev))

    return pieces


def assemble(model: nn.Module, chunks) -> nn.Module:
    """``model`` holding the whole tensors of its ``param_chunks`` pieces
    ``chunks``. Returns the model."""
    shapes = {n: p.shape for n, p in model.named_parameters()}
    sd = {}
    for name, start, values in chunks:
        if name not in sd:
            sd[name] = torch.empty(shapes[name], device=values.device)
        sd[name].view(-1)[start:start + values.numel()] = values
    model.load_state_dict(sd, assign=True)
    return model


class GatheredModule(nn.Module):
    """A model whose modules compute with their own parameters through
    :meth:`_gathered`: the module itself, or, when the engine trains under
    ZeRO stage 3 or ``offload_param`` and has set ``param_gatherer``, the
    parameters gathered just before the module runs and released after it
    (``runtime/zero/state.py``), or their compressed values under
    compression training (``compression/compress.py``). A model's top-level
    parameters gather once for each use (a tied embedding twice a forward);
    a block under ``remat`` gathers again when it is recomputed.
    ``stacked_layers``: the module lists whose layers the JAX package
    stacks into leaves with a leading L (the compression transform's
    paths)."""

    stacked_layers = ("blocks",)

    def __init__(self):
        super().__init__()
        # set by the engine: gather(module) / release(module)
        self.param_gatherer = None

    @contextlib.contextmanager
    def _gathered(self, module: nn.Module):
        """``module``'s own parameters to compute with (attribute access)."""
        gatherer = self.param_gatherer
        if gatherer is None:
            yield module
            return
        try:
            yield gatherer.gather(module)
        finally:
            gatherer.release(module)


@contextlib.contextmanager
def plain_math(model: nn.Module):
    """``model`` computing with the plain attention and no activation
    checkpointing, for a loss that is differentiated twice (the eigenvalue's
    Hessian-vector products): the flash kernels have no double backward,
    and a recomputed block is not differentiable twice. The model's config
    is swapped for the duration; a block-sparse config raises (its kernels
    have no double backward either)."""
    c = model.config
    if getattr(c, "sparse_attention", None) is not None:
        raise NotImplementedError("a Hessian-vector product through block-sparse attention: "
                                  "its kernels have no double backward")
    plain = {k: v for k, v in (("use_flash_attention", False), ("remat", False),
                               ("remat_loss_chunks", False)) if hasattr(c, k)}
    model.config = dataclasses.replace(c, **plain)
    try:
        yield model
    finally:
        model.config = c


def layer_norm(x, g, b, eps: float = 1e-5):
    """Layer norm over the last axis in fp32, cast back to ``x``'s type."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * g + b).to(x.dtype)


def _scaled_inv_freq(inv_freq, scaling: Optional[dict]):
    """Apply HF-style rope_scaling to the frequency vector."""
    if not scaling:
        return inv_freq
    kind = scaling.get("rope_type", scaling.get("type", "default"))
    if kind == "default":
        return inv_freq
    factor = float(scaling["factor"])
    if kind == "linear":
        return inv_freq / factor
    # "llama3": low-frequency components divided by `factor`, high-frequency
    # kept, smooth interpolation in between (transformers'
    # _compute_llama3_parameters)
    low = float(scaling["low_freq_factor"])
    high = float(scaling["high_freq_factor"])
    old_len = float(scaling["original_max_position_embeddings"])
    wavelen = 2.0 * math.pi / inv_freq
    smooth = (old_len / wavelen - low) / (high - low)
    smoothed = (1.0 - smooth) / factor * inv_freq + smooth * inv_freq
    scaled = torch.where(wavelen > old_len / low, inv_freq / factor, inv_freq)
    is_medium = (wavelen >= old_len / high) & (wavelen <= old_len / low)
    return torch.where(is_medium, smoothed, scaled)


def alibi_slopes(n_head: int) -> torch.Tensor:
    """ALiBi per-head slopes (H,) fp32, exactly HF BLOOM's
    ``build_alibi_tensor``: a geometric sequence on the nearest power of two
    below ``n_head``, and every other slope of the next power's sequence for
    the heads past it."""
    cp2 = 2 ** math.floor(math.log2(n_head))
    base = 2.0 ** (-(2.0 ** -(math.log2(cp2) - 3)))
    slopes = [base ** (i + 1) for i in range(cp2)]
    if cp2 != n_head:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * cp2) - 3)))
        slopes += [extra_base ** (i + 1) for i in range(0, 2 * (n_head - cp2), 2)]
    return torch.tensor(slopes, dtype=torch.float32)


def _rope_cos_sin(positions, head_dim: int, theta: float, scaling: Optional[dict] = None,
                  interleaved: bool = False):
    """cos/sin tables (T, Dh) for RoPE, fp32, on ``positions``' device.
    ``interleaved=False``: the rotate-half convention (LLaMA/NeoX), the
    frequencies concatenated twice; ``interleaved=True``: rotate-every-two
    (GPT-J), each frequency repeated for an adjacent pair of dims."""
    d2 = head_dim // 2
    exponent = torch.arange(d2, dtype=torch.float32, device=positions.device) / d2
    inv_freq = _scaled_inv_freq(1.0 / (theta ** exponent), scaling)
    ang = positions.float()[:, None] * inv_freq[None, :]   # (T, d2)
    if interleaved:
        return (torch.repeat_interleave(torch.cos(ang), 2, dim=-1),
                torch.repeat_interleave(torch.sin(ang), 2, dim=-1))
    cos = torch.cat([torch.cos(ang)] * 2, dim=-1)
    sin = torch.cat([torch.sin(ang)] * 2, dim=-1)
    return cos, sin


def apply_rope(x, cos, sin, interleaved: bool = False):
    """x: (B, T, H, Dh); cos/sin: (T, Dh) of the same convention. Computed
    in fp32, cast back."""
    x32 = x.float()
    if interleaved:
        # rotate every two: out[2i] = -x[2i+1], out[2i+1] = x[2i]
        rotated = torch.stack([-x32[..., 1::2], x32[..., ::2]], dim=-1).reshape(x32.shape)
    else:
        h1, h2 = x32.chunk(2, dim=-1)
        rotated = torch.cat([-h2, h1], dim=-1)
    out = x32 * cos[None, :, None, :] + rotated * sin[None, :, None, :]
    return out.to(x.dtype)


def _global(window: Optional[int]) -> bool:
    return window is None or window <= 0


def local_causal_attention(q, k, v, use_flash: bool = True, causal: bool = True,
                           key_padding_mask=None, alibi=None, window: Optional[int] = None):
    """Self-attention on (B, T, H, Dh) with equal head counts: the flash
    kernel when ``use_flash``, else the plain einsum. Causal by default;
    ``causal=False`` is the encoder (BERT) path. ``key_padding_mask``:
    optional (B, T), nonzero = attend; ``alibi``: optional (H,) slopes, the
    bias ``slopes[h] * j`` on key j; ``window``: a host int, GPT-Neo's local
    window (query i sees keys 0 <= i - j < window; None or <= 0: global). A
    masked, biased or windowed call takes the plain path, as the JAX
    dispatch sends it to the einsum (the kernels carry no mask or bias)."""
    if use_flash and key_padding_mask is None and alibi is None and _global(window):
        return flash_attention(q, k, v, causal=causal)
    return mha_reference(q, k, v, causal=causal, key_padding_mask=key_padding_mask,
                         alibi=alibi, window=window)


def cached_decode_attention(q, k_cache, v_cache, pos, use_flash_decode: bool = False,
                            alibi=None, window: Optional[int] = None):
    """Single-token decode attention over a KV cache. q: (B, H, Dh); caches
    (B, S, KV, Dh) valid through index ``pos``; KV may divide H (GQA).
    ``use_flash_decode`` selects the decode kernel, else the grouped einsum;
    ALiBi slopes or a window (> 0, a host int) take the grouped einsum, as
    in JAX. → (B, H, Dh)."""
    if use_flash_decode and alibi is None and _global(window):
        return decode_attention(q, k_cache, v_cache, pos)
    return decode_reference(q, k_cache, v_cache, pos, alibi=alibi, window=window)


def causal_attention(q, k, v, use_flash: bool = True, sequence_parallel=False, alibi=None,
                     window: Optional[int] = None):
    """The causal-attention dispatch shared by the model families: the
    single-device branch of the JAX ``causal_attention``. Sequence
    parallelism (ring / Ulysses) is a later slice of the port."""
    if sequence_parallel:
        raise NotImplementedError("sequence parallelism: later slice of the port")
    return local_causal_attention(q, k, v, use_flash, alibi=alibi, window=window)


# ------------------------------------------------------------------ remat
# the names open at the current op (``checkpoint_name``), innermost last
_NAMES: list = []
# ops without batch dimensions whose outputs "dots" keeps (a 3-D activation
# times a 2-D weight is one ``mm`` on the flattened rows)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_FLASH = torch.ops.ds_tpu_torch.flash_fwd.default


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Name the ops run inside, for a remat policy (JAX's ``checkpoint_name``
    names one value; here every op of the section carries the name)."""
    _NAMES.append(name)
    try:
        yield
    finally:
        _NAMES.pop()


def _remat_policy(policy: str, ctx, op, *args, **kwargs):
    """What a block under ``policy`` keeps: ``dots`` the outputs of ``mm`` /
    ``addmm``; ``attn`` the flash forward's (o, lse), so the recompute reads
    them back instead of launching K1; ``attn_mlp`` those and every op inside
    ``checkpoint_name("mlp_act")``. Everything else is recomputed."""
    if policy == "dots":
        keep = op in _DOTS
    else:
        keep = op is _FLASH or (policy == "attn_mlp" and "mlp_act" in _NAMES)
    return CheckpointPolicy.MUST_SAVE if keep else CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(policy, fn, *args):
    """``fn(*args)`` under the activation-checkpoint ``policy`` (a config's
    ``remat``): off (False, None, "none") runs it as it is; "full" keeps only
    its inputs; "dots", "attn" and "attn_mlp" keep what :func:`_remat_policy`
    says, by a selective checkpoint. Random draws inside ``fn`` must come
    from generators seeded inside it, so that the recompute draws the same."""
    if policy in (False, None, "none"):
        return fn(*args)
    if policy in (True, "full"):
        return checkpoint(fn, *args, use_reentrant=False)
    context = functools.partial(create_selective_checkpoint_contexts,
                                functools.partial(_remat_policy, policy))
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context)


def dropout(x, p: float, seed: Optional[int]):
    """Inverted dropout of ``x`` with drop rate ``p``: each element kept with
    probability 1 - p and scaled by 1 / (1 - p), as the JAX ``_dropout``. The
    mask comes from a generator seeded here with ``seed``, so a recompute
    under remat builds the same mask; ``seed`` None or ``p`` 0: no dropout."""
    if p == 0.0 or seed is None:
        return x
    gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


# odd 64-bit constant (the golden ratio's): a data-parallel rank's offset
# of the dropout seeds
_RANK_STRIDE = 0x9E3779B97F4A7C15


def draw_seeds(generator: torch.Generator, n: int, rank: int = 0) -> list:
    """``n`` seeds for per-site generators, drawn from ``generator`` before a
    layer loop (one host read), and offset by data-parallel ``rank``: every
    rank draws the same ``n`` values from its generator (which stays in
    step, so the PLD gates drawn after them agree), and rank r adds r times
    an odd constant, so its masks are its own, as the JAX package draws
    each mask over the global micro-batch; rank 0's seeds are the drawn
    ones."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=generator,
                          device=generator.device).tolist()
    return [(s + rank * _RANK_STRIDE) % 2 ** 62 for s in seeds]


def pld_gates(theta, n_layer: int, generator: torch.Generator):
    """Progressive layer drop's per-layer gates (L,) fp32: layer l kept with
    probability p_l (``layer_keep_probs``) and then scaled by 1 / p_l, else
    0, drawn from ``generator`` before the layer loop. A gated layer's output
    is ``x + gate * (block(x) - x)``, as the JAX ``_trunk`` gates it."""
    keep_p = layer_keep_probs(theta, n_layer, device=generator.device)
    keep = torch.rand(n_layer, generator=generator, device=generator.device) < keep_p
    return torch.where(keep, 1.0 / keep_p, torch.zeros_like(keep_p))


def gate_layer(x, y, gate):
    """``x + gate * (y - x)``, the gate cast to ``x``'s type (JAX's PLD
    residual gate); ``gate`` None returns ``y``."""
    return y if gate is None else x + gate.to(x.dtype) * (y - x)


def parse_lm_batch(batch):
    """dict with input_ids [+ labels/loss_mask] or bare (B, T) tensor →
    (ids, labels, loss_mask)."""
    if isinstance(batch, dict):
        ids = batch["input_ids"]
        return ids, batch.get("labels", ids), batch.get("loss_mask")
    return batch, batch, None


def lm_loss_tokens(batch) -> Optional[torch.Tensor]:
    """The weight ``chunked_lm_loss`` divides by for ``batch``: the loss
    mask's sum over the shifted targets (0-d fp32), or None without a mask
    (every target counts the same)."""
    _, _, mask = parse_lm_batch(batch)
    return None if mask is None else mask[:, 1:].float().sum()


def chunked_lm_loss(x, head, targets, loss_mask=None, bias=None, remat=True):
    """Mean next-token NLL with the vocab projection computed in sequence
    chunks, as the JAX ``chunked_lm_loss`` does (same chunk length).

    x: (B, T, D) final hidden states already shifted to align with
    ``targets`` (B, T); ``head``: (D, V) in compute dtype; ``loss_mask``:
    optional (B, T) weighting. ``remat`` runs each chunk under
    ``torch.utils.checkpoint``, so autograd keeps no chunk's fp32 logits
    and recomputes them in the backward.
    """
    B, T, D = x.shape
    vocab = head.shape[1]
    chunk = max(1, min(T, _CHUNK_ELEMS // max(1, B * vocab)))
    chunk = next((cc for cc in range(chunk, 0, -1) if T % cc == 0), 1)
    targets = targets.long()

    def chunk_nll(xc, tc):
        logits = (xc @ head).float()                                    # (B, C, V)
        if bias is not None:
            logits = logits + bias.float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, tc[..., None])[..., 0]
        return lse - tgt

    nll = []
    for i in range(0, T, chunk):
        xc, tc = x[:, i:i + chunk], targets[:, i:i + chunk]
        nll.append(checkpoint(chunk_nll, xc, tc, use_reentrant=False) if remat
                   else chunk_nll(xc, tc))
    nll = torch.cat(nll, dim=1)                                         # (B, T)
    if loss_mask is not None:
        m = loss_mask.float()
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)
