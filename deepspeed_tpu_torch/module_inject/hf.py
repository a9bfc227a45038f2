"""HF and diffusers checkpoints into the port's models: the vision part.

Counterpart of the stable-diffusion part of ``deepspeed_tpu/module_inject/
hf.py``: the CLIP text tower (``load_clip_text``), the UNet (``load_unet``)
and the VAE (``load_vae``), their flat export (``export_vision_params``) and
the dispatch ``load_hf_model`` for ``clip``, ``clip_text_model``, ``unet``
and ``vae`` (a diffusers object routes by its config's ``_class_name``).
Each loader returns (config, state dict of the port's model): the model is
built on the meta device and filled by ``init_inference(model,
params=state_dict)`` or ``model.load_state_dict(state_dict, assign=True)``.
The UNet's and the VAE's state dicts are the diffusers ones, key for key (a
dtype cast); CLIP's separate q/k/v fuse into the GPT-2 qkv matrix in the
port's ``x @ W`` orientation. The language-model architectures of the JAX
loader are a later slice of the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import logger

def hf_state_dict(model_or_sd: Any) -> Dict[str, torch.Tensor]:
    """A torch ``nn.Module`` | state dict | dict of arrays → dict of
    detached CPU tensors."""
    sd = model_or_sd
    if hasattr(sd, "state_dict") and callable(sd.state_dict):
        sd = sd.state_dict()
    return {k: (v.detach().cpu() if torch.is_tensor(v) else torch.from_numpy(np.asarray(v)))
            for k, v in sd.items()}


def _layer_count(sd: Mapping[str, Any], prefix: str, stem: str) -> int:
    """Number of contiguous '<prefix><stem>.<i>.' layers in the state dict."""
    ids = sorted({int(m.group(1)) for k in sd
                  for m in [re.match(rf"{re.escape(prefix)}{stem}\.(\d+)\.", k)] if m})
    assert ids == list(range(len(ids))), f"non-contiguous layers {ids}"
    return len(ids)


# ------------------------------------------------------------------- CLIP
def load_clip_text(model_or_sd: Any, dtype=torch.float32) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """HF ``CLIPTextModel`` (or the text tower of a ``CLIPModel``) →
    (GPT2Config, state dict) for ``models.clip.CLIPTextEncoder``.

    CLIP's text transformer is a pre-LN causal trunk with quick-GELU: the
    separate q/k/v fuse into the GPT-2 qkv matrix and ``final_layer_norm``
    lands in the ``lnf`` slots. The port's GPT-2 MLP is 4 x ``n_embd`` wide
    (CLIP ViT-L/14's text tower is); another width raises. The config's
    ``eos_token_id`` rides on the returned config, for ``pooled``."""
    from deepspeed_tpu_torch.models.gpt2 import BLOCK_KEYS, GPT2Config

    cfg = getattr(model_or_sd, "config", None)
    if cfg is not None and hasattr(cfg, "text_config"):   # a whole CLIPModel
        cfg = cfg.text_config
    n_head = int(getattr(cfg, "num_attention_heads", 0) or 0)
    if not n_head:
        raise ValueError("load_clip_text needs the HF model (its config carries "
                         "num_attention_heads), not a bare state dict")

    sd = hf_state_dict(model_or_sd)
    prefix = "text_model." if any(k.startswith("text_model.") for k in sd) else ""
    g = lambda name: sd[prefix + name].to(dtype)
    n_layer = _layer_count(sd, prefix, "encoder.layers")
    wte = g("embeddings.token_embedding.weight")
    vocab, d = wte.shape
    if g("encoder.layers.0.mlp.fc1.weight").shape[0] != 4 * d:
        raise NotImplementedError("a CLIP MLP wider or narrower than 4 x hidden_size: "
                                  "later slice of the port")

    out = {"wte": wte, "wpe": g("embeddings.position_embedding.weight"),
           "lnf_g": g("final_layer_norm.weight"), "lnf_b": g("final_layer_norm.bias")}
    for i in range(n_layer):
        p = f"encoder.layers.{i}."
        a = p + "self_attn."
        layer = {
            "ln1_g": g(p + "layer_norm1.weight"), "ln1_b": g(p + "layer_norm1.bias"),
            "qkv_w": torch.cat([g(a + f"{n}_proj.weight").t() for n in "qkv"], dim=1),
            "qkv_b": torch.cat([g(a + f"{n}_proj.bias") for n in "qkv"]),
            "proj_w": g(a + "out_proj.weight").t(), "proj_b": g(a + "out_proj.bias"),
            "ln2_g": g(p + "layer_norm2.weight"), "ln2_b": g(p + "layer_norm2.bias"),
            "fc_w": g(p + "mlp.fc1.weight").t(), "fc_b": g(p + "mlp.fc1.bias"),
            "fc2_w": g(p + "mlp.fc2.weight").t(), "fc2_b": g(p + "mlp.fc2.bias")}
        out.update({f"blocks.{i}.{k}": layer[k].contiguous() for k in BLOCK_KEYS})

    act = str(getattr(cfg, "hidden_act", "quick_gelu") or "quick_gelu")
    if act not in ("gelu", "quick_gelu"):
        raise NotImplementedError(f"CLIP hidden_act {act!r} not supported")
    config = GPT2Config(vocab_size=vocab,
                        n_positions=int(getattr(cfg, "max_position_embeddings", 77) or 77),
                        n_embd=d, n_layer=n_layer, n_head=n_head, activation=act, dtype=dtype)
    eos = getattr(cfg, "eos_token_id", None)
    config._clip_eos_token_id = int(eos) if eos is not None else None
    logger.info(f"load_clip_text: {n_layer} layers, d={d}, vocab={vocab}, heads={n_head}")
    return config, out


def _clip_model(config):
    from deepspeed_tpu_torch.models.clip import CLIPTextEncoder

    return CLIPTextEncoder(config, eos_token_id=getattr(config, "_clip_eos_token_id", None))


# -------------------------------------------------------- diffusers (vision)
def _vision_sd(model_or_sd: Any, dtype) -> Dict[str, torch.Tensor]:
    return {k: v.to(dtype) for k, v in hf_state_dict(model_or_sd).items()}


def load_unet(model_or_sd: Any, dtype=torch.float32, config=None):
    """diffusers ``UNet2DConditionModel`` (or its state dict with an explicit
    ``config``) → (UNetConfig, state dict) for
    ``models.diffusion.UNet2DConditionModel``: the diffusers keys, cast."""
    from deepspeed_tpu_torch.models.diffusion import UNetConfig

    sd = _vision_sd(model_or_sd, dtype)
    if config is None:
        hf = getattr(model_or_sd, "config", None)
        if hf is None:
            raise ValueError("load_unet needs a diffusers model (its config carries "
                             "the block layout) or an explicit UNetConfig")
        # diffusers' attention_head_dim is the head COUNT (per down block in
        # SD-2.x); UNetConfig keeps its name and meaning
        hd = getattr(hf, "attention_head_dim", 8)
        hd = tuple(hd) if isinstance(hd, (list, tuple)) else int(hd)
        config = UNetConfig(
            in_channels=int(hf.in_channels), out_channels=int(hf.out_channels),
            block_out_channels=tuple(hf.block_out_channels),
            layers_per_block=int(hf.layers_per_block),
            down_block_types=tuple(hf.down_block_types),
            up_block_types=tuple(hf.up_block_types),
            cross_attention_dim=int(hf.cross_attention_dim), attention_head_dim=hd,
            norm_num_groups=int(getattr(hf, "norm_num_groups", 32) or 32),
            use_linear_projection=bool(getattr(hf, "use_linear_projection", False)),
            dtype=dtype)
    logger.info(f"load_unet: blocks={config.block_out_channels}, "
                f"ctx={config.cross_attention_dim}")
    return config, sd


def load_vae(model_or_sd: Any, dtype=torch.float32, config=None):
    """diffusers ``AutoencoderKL`` (or its state dict with an explicit
    ``config``) → (VAEConfig, state dict) for ``models.diffusion.AutoencoderKL``."""
    from deepspeed_tpu_torch.models.diffusion import VAEConfig

    sd = _vision_sd(model_or_sd, dtype)
    if config is None:
        hf = getattr(model_or_sd, "config", None)
        if hf is None:
            raise ValueError("load_vae needs a diffusers model or an explicit VAEConfig")
        config = VAEConfig(
            in_channels=int(hf.in_channels), out_channels=int(hf.out_channels),
            latent_channels=int(hf.latent_channels),
            block_out_channels=tuple(hf.block_out_channels),
            layers_per_block=int(hf.layers_per_block),
            norm_num_groups=int(getattr(hf, "norm_num_groups", 32) or 32),
            scaling_factor=float(getattr(hf, "scaling_factor", 0.18215) or 0.18215),
            dtype=dtype)
    logger.info(f"load_vae: blocks={config.block_out_channels}, "
                f"latent={config.latent_channels}")
    return config, sd


def export_vision_params(params: Any) -> Dict[str, np.ndarray]:
    """A model (its state dict), a nested diffusers-layout tree (the JAX
    package's) or a flat dict → flat dotted dict of numpy arrays, as
    diffusers names them."""
    from deepspeed_tpu_torch.models.diffusion import flatten_tree

    if hasattr(params, "state_dict") and callable(params.state_dict):
        params = params.state_dict()
    return {k: _numpy(v) for k, v in flatten_tree(params).items()}


def _numpy(v) -> np.ndarray:
    """A tensor (bf16 widened to fp32: numpy has no bf16) or array as numpy."""
    if not torch.is_tensor(v):
        return np.asarray(v)
    v = v.detach().cpu()
    return (v.float() if v.dtype == torch.bfloat16 else v).numpy()


def _vision_factory(architecture: str):
    def make(config):
        from deepspeed_tpu_torch.models.diffusion import AutoencoderKL, UNet2DConditionModel

        return (UNet2DConditionModel(config) if architecture == "unet"
                else AutoencoderKL(config))
    return make


# architecture → (state-dict loader, model factory)
_LOADERS = {"clip": (load_clip_text, _clip_model),
            "clip_text_model": (load_clip_text, _clip_model),
            "unet": (load_unet, _vision_factory("unet")),
            "vae": (load_vae, _vision_factory("vae"))}


def load_hf_model(model_or_sd: Any, architecture: Optional[str] = None, dtype=torch.float32):
    """HF or diffusers model / state dict → (the port's model, its state
    dict), ready for ``init_inference(model=..., params=...)``.

    ``architecture`` defaults to the HF config's ``model_type``, or, for a
    diffusers config, its ``_class_name`` (``UNet2DConditionModel`` → unet,
    ``AutoencoderKL`` → vae). The JAX loader's language-model architectures
    raise ``NotImplementedError`` here (a later slice of the port)."""
    if architecture is None:
        cfg = getattr(model_or_sd, "config", None)
        architecture = getattr(cfg, "model_type", None)
        if not architecture and cfg is not None:
            cls_name = getattr(cfg, "_class_name", None)
            if cls_name is None and isinstance(cfg, dict):
                cls_name = cfg.get("_class_name")
            architecture = {"UNet2DConditionModel": "unet",
                            "AutoencoderKL": "vae"}.get(cls_name)
    if architecture not in _LOADERS:
        raise NotImplementedError(
            f"loading architecture {architecture!r}: the port loads {sorted(_LOADERS)}; "
            "the language-model loaders are a later slice of the port")
    loader, model_factory = _LOADERS[architecture]
    config, params = loader(model_or_sd, dtype=dtype)
    return model_factory(config), params
