"""Stable-diffusion vision models: UNet2DCondition and AutoencoderKL (VAE).

Counterpart of ``deepspeed_tpu/models/diffusion.py``, served through
``init_inference`` → ``InferenceEngine.forward``. The parameter tree is the
diffusers state dict with torch layouts (Linear (out, in), Conv2d OIHW, NCHW
activations): each level of it is a module whose parameters and children
carry their diffusers names, so ``state_dict()`` keys are the diffusers keys
(``down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight``) and
a diffusers state dict loads with ``load_state_dict`` unchanged. The forward
indexes the same names as the JAX forward does (``p["conv1"]["weight"]``).
Supported blocks (the SD family): CrossAttnDownBlock2D / DownBlock2D /
UNetMidBlock2DCrossAttn / CrossAttnUpBlock2D / UpBlock2D,
DownEncoderBlock2D / UpDecoderBlock2D, the VAE mid attention, GEGLU
feed-forwards, and conv- and linear-projection Transformer2D (told apart by
the weight's rank).

Every attention, the UNet's self- and cross-attention (77 context keys) and
the VAE's single-head mid attention (head dim 512), goes through
``models/common.py``'s ``local_causal_attention(..., causal=False)``: the
flash forward kernel on a CUDA tensor, its plain version on a CPU tensor.
The convolutions are ``F.conv2d``, as XLA computes them outside any Pallas
kernel in JAX. Two numeric choices of the JAX model, which differ from
diffusers, are kept: the GEGLU gate's GELU is the tanh approximation
(``jax.nn.gelu``'s default) and every group norm takes eps 1e-6.

Weights: ``init_params(generator)`` (normal / sqrt(fan in) weights, zero
biases, unit norm gains, the JAX package's distribution from a torch
generator), :func:`params_from_jax` (the JAX tree as numpy, its names
flattened with "."), or ``module_inject.hf.load_unet`` / ``load_vae``.
Tensor-parallel specs (``param_partition_specs``) are a later slice of the
port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.common import (assemble, init_pieces, layer_norm,
                                                local_causal_attention, meta_weight)

# ------------------------------------------------------------------ primitives


def _linear(x, p):
    bias = p["bias"].to(x.dtype) if "bias" in p else None
    return F.linear(x, p["weight"].to(x.dtype), bias)


def _conv(x, p, stride=1, padding=1):
    bias = p["bias"].to(x.dtype) if "bias" in p else None
    return F.conv2d(x, p["weight"].to(x.dtype), bias, stride=stride, padding=padding)


def _group_norm(x, p, groups: int, eps: float = 1e-6):
    """Group norm in fp32, cast back to ``x``'s type."""
    y = F.group_norm(x.float(), groups, p["weight"].float(), p["bias"].float(), eps)
    return y.to(x.dtype)


def _layer_norm(x, p, eps: float = 1e-5):
    return layer_norm(x, p["weight"].float(), p["bias"].float(), eps)


def _silu(x):
    return x * torch.sigmoid(x)


def _mha(q, k, v, n_heads: int):
    """(B, Tq, C) x (B, Tk, C) attention, projections applied by the caller,
    through the shared non-causal dispatch (the flash kernel on the card)."""
    B, Tq, C = q.shape
    Tk = k.shape[1]
    dh = C // n_heads
    out = local_causal_attention(q.reshape(B, Tq, n_heads, dh), k.reshape(B, Tk, n_heads, dh),
                                 v.reshape(B, Tk, n_heads, dh), use_flash=True, causal=False)
    return out.reshape(B, Tq, C)


def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0):
    """diffusers get_timestep_embedding (flip_sin_to_cos=True,
    downscale_freq_shift=0, the SD UNet's): (B,) → (B, dim) fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    ang = timesteps.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


# ------------------------------------------------------------------- configs
@dataclasses.dataclass
class UNetConfig:
    """Mirrors the diffusers UNet2DConditionModel config; the defaults are
    SD-1.5's (``runwayml/stable-diffusion-v1-5`` ``unet/config.json``)."""
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    down_block_types: Tuple[str, ...] = ("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",)
    up_block_types: Tuple[str, ...] = ("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3
    cross_attention_dim: int = 768
    # diffusers' knob of this name is the HEAD COUNT (UNet2DConditionModel
    # passes it as Transformer2DModel.num_attention_heads; SD-1.5: 8 heads,
    # of dim 40, 80 and 160). A per-down-block list (SD-2.x) is read
    # reversed by the up blocks.
    attention_head_dim: Any = 8
    norm_num_groups: int = 32
    use_linear_projection: bool = False
    dtype: Any = torch.float32       # compute type

    def heads_for(self, down_block_idx: int) -> int:
        hd = self.attention_head_dim
        if isinstance(hd, (list, tuple)):
            return int(hd[down_block_idx])
        return int(hd)

    def __post_init__(self):
        if len(self.down_block_types) != len(self.block_out_channels):
            raise ValueError("down_block_types must match block_out_channels")
        if len(self.up_block_types) != len(self.block_out_channels):
            raise ValueError("up_block_types must match block_out_channels")
        if isinstance(self.attention_head_dim, (list, tuple)) and \
                len(self.attention_head_dim) != len(self.block_out_channels):
            raise ValueError("per-block attention_head_dim must match "
                             "block_out_channels")
        for t in self.down_block_types:
            if t not in ("CrossAttnDownBlock2D", "DownBlock2D"):
                raise NotImplementedError(f"down block {t!r}")
        for t in self.up_block_types:
            if t not in ("CrossAttnUpBlock2D", "UpBlock2D"):
                raise NotImplementedError(f"up block {t!r}")


@dataclasses.dataclass
class VAEConfig:
    """Mirrors the diffusers AutoencoderKL config; the defaults are SD-1.5's
    (``vae/config.json``)."""
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: Any = torch.float32       # compute type


# ------------------------------------------------------------ parameter tree
# A tree spec is a nested dict: a leaf is (shape, scale) for normal draws
# times scale, or (shape, None, fill) for a constant.

def _lin(i: int, o: int, bias: bool = True) -> dict:
    p = {"weight": ((o, i), 1.0 / math.sqrt(i))}
    if bias:
        p["bias"] = ((o,), None, 0.0)
    return p


def _convp(i: int, o: int, k: int = 3) -> dict:
    return {"weight": ((o, i, k, k), 1.0 / math.sqrt(i * k * k)), "bias": ((o,), None, 0.0)}


def _norm(c: int) -> dict:
    return {"weight": ((c,), None, 1.0), "bias": ((c,), None, 0.0)}


def _resnet_spec(ci: int, co: int, temb_dim=None) -> dict:
    p = {"norm1": _norm(ci), "conv1": _convp(ci, co)}
    if temb_dim is not None:
        p["time_emb_proj"] = _lin(temb_dim, co)
    p.update({"norm2": _norm(co), "conv2": _convp(co, co)})
    if ci != co:
        p["conv_shortcut"] = _convp(ci, co, k=1)
    return p


def unet_spec(cfg: UNetConfig) -> Dict[str, Any]:
    """The UNet's tree spec, in the JAX ``init_params`` layout."""

    def attn_block(c):
        d_ctx = cfg.cross_attention_dim
        proj = (lambda: _lin(c, c)) if cfg.use_linear_projection else (lambda: _convp(c, c, 1))
        return {
            "norm": _norm(c), "proj_in": proj(), "proj_out": proj(),
            "transformer_blocks": {"0": {
                "norm1": _norm(c),
                "attn1": {"to_q": _lin(c, c, False), "to_k": _lin(c, c, False),
                          "to_v": _lin(c, c, False), "to_out": {"0": _lin(c, c)}},
                "norm2": _norm(c),
                "attn2": {"to_q": _lin(c, c, False), "to_k": _lin(d_ctx, c, False),
                          "to_v": _lin(d_ctx, c, False), "to_out": {"0": _lin(c, c)}},
                "norm3": _norm(c),
                "ff": {"net": {"0": {"proj": _lin(c, 8 * c)}, "2": _lin(4 * c, c)}},
            }}}

    # diffusers: sinusoid dim = bc[0], time_embed_dim = 4 * bc[0]
    sin_dim = cfg.block_out_channels[0]
    t_dim = 4 * sin_dim
    spec: Dict[str, Any] = {
        "conv_in": _convp(cfg.in_channels, cfg.block_out_channels[0]),
        "time_embedding": {"linear_1": _lin(sin_dim, t_dim), "linear_2": _lin(t_dim, t_dim)},
        "down_blocks": {}, "up_blocks": {},
        "conv_norm_out": _norm(cfg.block_out_channels[0]),
        "conv_out": _convp(cfg.block_out_channels[0], cfg.out_channels),
    }
    ch = cfg.block_out_channels[0]
    down_out = [ch]
    for bi, btype in enumerate(cfg.down_block_types):
        co = cfg.block_out_channels[bi]
        blk: Dict[str, Any] = {"resnets": {}, "attentions": {}}
        for li in range(cfg.layers_per_block):
            blk["resnets"][str(li)] = _resnet_spec(ch if li == 0 else co, co, t_dim)
            if btype == "CrossAttnDownBlock2D":
                blk["attentions"][str(li)] = attn_block(co)
            down_out.append(co)
        if not blk["attentions"]:
            del blk["attentions"]
        if bi < len(cfg.down_block_types) - 1:
            blk["downsamplers"] = {"0": {"conv": _convp(co, co)}}
            down_out.append(co)
        spec["down_blocks"][str(bi)] = blk
        ch = co

    spec["mid_block"] = {
        "resnets": {"0": _resnet_spec(ch, ch, t_dim), "1": _resnet_spec(ch, ch, t_dim)},
        "attentions": {"0": attn_block(ch)}}

    rev = list(reversed(cfg.block_out_channels))
    for bi, btype in enumerate(cfg.up_block_types):
        co = rev[bi]
        blk = {"resnets": {}, "attentions": {}}
        for li in range(cfg.layers_per_block + 1):
            skip = down_out.pop()
            blk["resnets"][str(li)] = _resnet_spec(ch + skip, co, t_dim)
            if btype == "CrossAttnUpBlock2D":
                blk["attentions"][str(li)] = attn_block(co)
            ch = co
        if not blk["attentions"]:
            del blk["attentions"]
        if bi < len(cfg.up_block_types) - 1:
            blk["upsamplers"] = {"0": {"conv": _convp(co, co)}}
        spec["up_blocks"][str(bi)] = blk
    return spec


def vae_spec(cfg: VAEConfig) -> Dict[str, Any]:
    """The VAE's tree spec, in the JAX ``init_params`` layout."""

    def mid(c):
        return {"resnets": {"0": _resnet_spec(c, c), "1": _resnet_spec(c, c)},
                "attentions": {"0": {"group_norm": _norm(c), "to_q": _lin(c, c),
                                     "to_k": _lin(c, c), "to_v": _lin(c, c),
                                     "to_out": {"0": _lin(c, c)}}}}

    bc = cfg.block_out_channels
    enc: Dict[str, Any] = {"conv_in": _convp(cfg.in_channels, bc[0]), "down_blocks": {}}
    ch = bc[0]
    for bi, co in enumerate(bc):
        blk: Dict[str, Any] = {"resnets": {}}
        for li in range(cfg.layers_per_block):
            blk["resnets"][str(li)] = _resnet_spec(ch if li == 0 else co, co)
        if bi < len(bc) - 1:
            blk["downsamplers"] = {"0": {"conv": _convp(co, co)}}
        enc["down_blocks"][str(bi)] = blk
        ch = co
    enc["mid_block"] = mid(ch)
    enc["conv_norm_out"] = _norm(ch)
    enc["conv_out"] = _convp(ch, 2 * cfg.latent_channels)

    dec: Dict[str, Any] = {"conv_in": _convp(cfg.latent_channels, bc[-1]), "up_blocks": {}}
    ch = bc[-1]
    for bi, co in enumerate(reversed(bc)):
        blk = {"resnets": {}}
        for li in range(cfg.layers_per_block + 1):
            blk["resnets"][str(li)] = _resnet_spec(ch if li == 0 else co, co)
            ch = co
        if bi < len(bc) - 1:
            blk["upsamplers"] = {"0": {"conv": _convp(co, co)}}
        dec["up_blocks"][str(bi)] = blk
    dec["mid_block"] = mid(bc[-1])       # runs before the up blocks, at bc[-1] channels
    dec["conv_norm_out"] = _norm(bc[0])
    dec["conv_out"] = _convp(bc[0], cfg.out_channels)
    return {"encoder": enc, "decoder": dec,
            "quant_conv": _convp(2 * cfg.latent_channels, 2 * cfg.latent_channels, k=1),
            "post_quant_conv": _convp(cfg.latent_channels, cfg.latent_channels, k=1)}


class TreeNode(nn.Module):
    """One level of a diffusers tree: its leaves are parameters and its
    subtrees child modules, each under its diffusers name, indexed like the
    JAX dict tree (``node["conv1"]["weight"]``, ``"bias" in node``)."""

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def keys(self):
        return [*self._parameters, *self._modules]

    def _grow(self, spec: Mapping[str, Any]) -> None:
        """Parameters on the meta device and child nodes, as ``spec`` says."""
        for key, val in spec.items():
            if isinstance(val, dict):
                child = TreeNode()
                child._grow(val)
                self.add_module(key, child)
            else:
                self.register_parameter(key, meta_weight(*val[0]))


def _spec_pieces(spec: Mapping[str, Any], generator: torch.Generator):
    """The ``(name, start, values)`` pieces of every leaf of ``spec``, in its
    order: normal draws times the leaf's scale, or its fill."""
    pieces = init_pieces(generator)

    def walk(node, prefix):
        for key, val in node.items():
            name = f"{prefix}{key}"
            if isinstance(val, dict):
                yield from walk(val, name + ".")
            elif val[1] is not None:
                yield from pieces(name, val[0], val[1])
            else:
                yield from pieces(name, val[0], fill=val[2])

    return walk(spec, "")


class _VisionModel(TreeNode):
    """A model over a spec tree: parameters on meta until filled."""

    def __init__(self, config, spec: Mapping[str, Any]):
        super().__init__()
        self.config = config
        self._spec = spec
        self._grow(spec)

    def init_params(self, generator: torch.Generator):
        """Random fp32 weights from ``generator`` on its device (normal /
        sqrt(fan in) weights, zero biases, unit norm gains). Returns self."""
        return assemble(self, _spec_pieces(self._spec, generator))


# -------------------------------------------------------------- shared blocks
def _resnet(x, p, temb, groups):
    h = _conv(_silu(_group_norm(x, p["norm1"], groups)), p["conv1"])
    if temb is not None and "time_emb_proj" in p:
        h = h + _linear(_silu(temb), p["time_emb_proj"])[:, :, None, None]
    h = _conv(_silu(_group_norm(h, p["norm2"], groups)), p["conv2"])
    if "conv_shortcut" in p:
        x = _conv(x, p["conv_shortcut"], padding=0)
    return x + h


def _proj_2d(x_or_tokens, p):
    """Transformer2D proj_in / proj_out: Conv2d 1x1 (SD-1) or Linear (SD-2),
    told apart by the stored weight's rank."""
    if p["weight"].dim() == 4:
        return _conv(x_or_tokens, p, padding=0)
    return _linear(x_or_tokens, p)


def _transformer_2d(x, p, ctx, cfg: UNetConfig, n_heads: int):
    """diffusers Transformer2DModel with its BasicTransformerBlocks (the SD
    shape): self-attention, cross-attention over ``ctx``, GEGLU
    feed-forward."""
    B, C, H, W = x.shape
    resid = x
    h = _group_norm(x, p["norm"], cfg.norm_num_groups)
    if p["proj_in"]["weight"].dim() == 4:
        h = _proj_2d(h, p["proj_in"])
        tokens = h.reshape(B, C, H * W).transpose(1, 2)         # (B, HW, C)
    else:
        tokens = _proj_2d(h.reshape(B, C, H * W).transpose(1, 2), p["proj_in"])

    blocks = p["transformer_blocks"]
    for key in sorted(blocks.keys(), key=int):
        tb = blocks[key]
        t = _layer_norm(tokens, tb["norm1"])
        p_attn = tb["attn1"]
        attn = _mha(_linear(t, p_attn["to_q"]), _linear(t, p_attn["to_k"]),
                    _linear(t, p_attn["to_v"]), n_heads)
        tokens = tokens + _linear(attn, p_attn["to_out"]["0"])
        t = _layer_norm(tokens, tb["norm2"])
        p_attn = tb["attn2"]
        attn = _mha(_linear(t, p_attn["to_q"]), _linear(ctx, p_attn["to_k"]),
                    _linear(ctx, p_attn["to_v"]), n_heads)
        tokens = tokens + _linear(attn, p_attn["to_out"]["0"])
        t = _layer_norm(tokens, tb["norm3"])
        a, b = _linear(t, tb["ff"]["net"]["0"]["proj"]).chunk(2, dim=-1)    # GEGLU
        tokens = tokens + _linear(a * F.gelu(b, approximate="tanh"), tb["ff"]["net"]["2"])

    if p["proj_out"]["weight"].dim() == 4:
        h = _proj_2d(tokens.transpose(1, 2).reshape(B, C, H, W), p["proj_out"])
    else:
        h = _proj_2d(tokens, p["proj_out"]).transpose(1, 2).reshape(B, C, H, W)
    return h + resid


def _vae_attention(x, p, groups):
    """AutoencoderKL mid-block single-head spatial attention."""
    B, C, H, W = x.shape
    h = _group_norm(x, p["group_norm"], groups)
    tokens = h.reshape(B, C, H * W).transpose(1, 2)
    attn = _mha(_linear(tokens, p["to_q"]), _linear(tokens, p["to_k"]),
                _linear(tokens, p["to_v"]), n_heads=1)
    out = _linear(attn, p["to_out"]["0"])
    return x + out.transpose(1, 2).reshape(B, C, H, W)


def _upsample(x):
    """Nearest x2, which ``jax.image.resize(..., "nearest")`` gives at x2."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


# ------------------------------------------------------------ UNet2DCondition
class UNet2DConditionModel(_VisionModel):
    """The SD UNet: ``apply(sample, timestep, encoder_hidden_states)`` →
    noise prediction (B, out_channels, H, W) in the compute type."""

    def __init__(self, config: UNetConfig):
        super().__init__(config, unet_spec(config))

    def apply(self, sample, timestep, encoder_hidden_states):
        cfg = self.config
        g = cfg.norm_num_groups
        ctx = encoder_hidden_states.to(cfg.dtype)
        x = sample.to(cfg.dtype)
        if timestep.dim() == 0:
            timestep = timestep[None]

        temb = timestep_embedding(timestep, cfg.block_out_channels[0]).to(cfg.dtype)
        temb = _linear(temb, self["time_embedding"]["linear_1"])
        temb = _linear(_silu(temb), self["time_embedding"]["linear_2"])

        x = _conv(x, self["conv_in"])
        residuals = [x]
        for bi, btype in enumerate(cfg.down_block_types):
            blk = self["down_blocks"][str(bi)]
            for li in range(cfg.layers_per_block):
                x = _resnet(x, blk["resnets"][str(li)], temb, g)
                if btype == "CrossAttnDownBlock2D":
                    x = _transformer_2d(x, blk["attentions"][str(li)], ctx, cfg,
                                        cfg.heads_for(bi))
                residuals.append(x)
            if "downsamplers" in blk:
                x = _conv(x, blk["downsamplers"]["0"]["conv"], stride=2)
                residuals.append(x)

        mid = self["mid_block"]
        x = _resnet(x, mid["resnets"]["0"], temb, g)
        x = _transformer_2d(x, mid["attentions"]["0"], ctx, cfg,
                            cfg.heads_for(len(cfg.down_block_types) - 1))
        x = _resnet(x, mid["resnets"]["1"], temb, g)

        for bi, btype in enumerate(cfg.up_block_types):
            blk = self["up_blocks"][str(bi)]
            for li in range(cfg.layers_per_block + 1):
                x = torch.cat([x, residuals.pop()], dim=1)
                x = _resnet(x, blk["resnets"][str(li)], temb, g)
                if btype == "CrossAttnUpBlock2D":
                    x = _transformer_2d(x, blk["attentions"][str(li)], ctx, cfg,
                                        cfg.heads_for(len(cfg.down_block_types) - 1 - bi))
            if "upsamplers" in blk:
                x = _conv(_upsample(x), blk["upsamplers"]["0"]["conv"])

        x = _silu(_group_norm(x, self["conv_norm_out"], g))
        return _conv(x, self["conv_out"])

    forward = apply


# --------------------------------------------------------------- AutoencoderKL
class AutoencoderKL(_VisionModel):
    """The SD VAE: ``encode`` → scaled latent mean, ``decode`` → image,
    ``apply`` = decode(encode(x))."""

    def __init__(self, config: VAEConfig):
        super().__init__(config, vae_spec(config))

    def encode(self, x):
        """(B, in, H, W) → latent mean (B, latent, H / 8, W / 8) times the
        scaling factor: the posterior's mode (sampling adds noise at the
        pipeline level)."""
        cfg = self.config
        g = cfg.norm_num_groups
        enc = self["encoder"]
        h = _conv(x.to(cfg.dtype), enc["conv_in"])
        for bi in range(len(cfg.block_out_channels)):
            blk = enc["down_blocks"][str(bi)]
            for li in range(cfg.layers_per_block):
                h = _resnet(h, blk["resnets"][str(li)], None, g)
            if "downsamplers" in blk:
                # diffusers' VAE downsample pads asymmetrically: (0, 1, 0, 1)
                h = _conv(F.pad(h, (0, 1, 0, 1)), blk["downsamplers"]["0"]["conv"], stride=2,
                          padding=0)
        mid = enc["mid_block"]
        h = _resnet(h, mid["resnets"]["0"], None, g)
        h = _vae_attention(h, mid["attentions"]["0"], g)
        h = _resnet(h, mid["resnets"]["1"], None, g)
        h = _conv(_silu(_group_norm(h, enc["conv_norm_out"], g)), enc["conv_out"])
        moments = _conv(h, self["quant_conv"], padding=0)
        mean, _logvar = moments.chunk(2, dim=1)
        return mean * cfg.scaling_factor

    def decode(self, z):
        """(B, latent, h, w) scaled latent → (B, out, 8 h, 8 w) image."""
        cfg = self.config
        g = cfg.norm_num_groups
        dec = self["decoder"]
        z = (z / cfg.scaling_factor).to(cfg.dtype)
        h = _conv(z, self["post_quant_conv"], padding=0)
        h = _conv(h, dec["conv_in"])
        mid = dec["mid_block"]
        h = _resnet(h, mid["resnets"]["0"], None, g)
        h = _vae_attention(h, mid["attentions"]["0"], g)
        h = _resnet(h, mid["resnets"]["1"], None, g)
        for bi in range(len(cfg.block_out_channels)):
            blk = dec["up_blocks"][str(bi)]
            for li in range(cfg.layers_per_block + 1):
                h = _resnet(h, blk["resnets"][str(li)], None, g)
            if "upsamplers" in blk:
                h = _conv(_upsample(h), blk["upsamplers"]["0"]["conv"])
        return _conv(_silu(_group_norm(h, dec["conv_norm_out"], g)), dec["conv_out"])

    def apply(self, x):
        """The autoencode round trip (the serving path)."""
        return self.decode(self.encode(x))

    forward = apply


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested dict tree → flat dict with "."-joined keys."""
    flat: Dict[str, Any] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(flatten_tree(val, name + "."))
        else:
            flat[name] = val
    return flat


def params_from_jax(np_params: Mapping[str, Any], config):
    """The UNet (for a :class:`UNetConfig`) or the VAE (for a
    :class:`VAEConfig`) holding the JAX package's nested diffusers tree, as
    numpy arrays: its names joined with ".", the copy exact."""
    model = (UNet2DConditionModel(config) if isinstance(config, UNetConfig)
             else AutoencoderKL(config))
    sd = {k: torch.tensor(np.asarray(v)) for k, v in flatten_tree(np_params).items()}
    model.load_state_dict(sd, assign=True)
    return model
