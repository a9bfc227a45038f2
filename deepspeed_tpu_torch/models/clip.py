"""CLIP text encoder: the conditioning tower of the stable-diffusion stack.

Counterpart of ``deepspeed_tpu/models/clip.py``. HF's ``CLIPTextTransformer``
is a GPT-2-style pre-LN causal trunk (x += attn(ln1(x)); x += mlp(ln2(x));
final layer norm) with the quick-GELU activation, so it rides the port's
:class:`GPT2Model` unchanged: causal flash attention (T = 77, head dim 64 for
``openai/clip-vit-large-patch14``) and ``init_inference``. What CLIP adds is
the output: no LM head; ``apply`` returns the final hidden states and
``pooled`` gathers the end-of-text feature. The port's GPT-2 blocks have an
MLP of 4 x ``n_embd`` (CLIP ViT-L/14's text tower: 3072 for 768).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model


class CLIPTextEncoder(GPT2Model):
    """HF CLIPTextModel's forward on converted weights."""

    def __init__(self, config: GPT2Config, eos_token_id: Optional[int] = None):
        super().__init__(config)
        self.eos_token_id = eos_token_id

    def apply(self, input_ids):
        """(B, T) → last_hidden_state (B, T, D), after the final layer norm."""
        return self.hidden_states(input_ids)

    forward = apply

    def pooled(self, input_ids):
        """The end-of-text feature (B, D), HF's pooler_output: the hidden
        state at the argmax of the ids (HF's pre-1.5 convention, where EOS is
        the largest id) without an ``eos_token_id``, else at its first
        occurrence."""
        x = self.apply(input_ids)
        if self.eos_token_id is None:
            eot = torch.argmax(input_ids, dim=-1)
        else:
            eot = torch.argmax((input_ids == self.eos_token_id).int(), dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eot]

    def loss(self, batch, **kwargs):
        raise NotImplementedError(
            "CLIPTextEncoder is a serving-side conditioning tower; "
            "contrastive pretraining is out of scope")


def params_from_jax(np_params: Mapping[str, Any], config: GPT2Config,
                    eos_token_id: Optional[int] = None) -> CLIPTextEncoder:
    """A CLIPTextEncoder holding the JAX package's GPT-2 tree (as numpy),
    copied exactly as ``gpt2.params_from_jax`` copies it; ``eos_token_id``
    defaults to the one ``load_clip_text`` rides on the config."""
    if eos_token_id is None:
        eos_token_id = getattr(config, "_clip_eos_token_id", None)
    model = CLIPTextEncoder(config, eos_token_id=eos_token_id)
    model.load_state_dict(gpt2.params_from_jax(np_params, config).state_dict(), assign=True)
    return model
