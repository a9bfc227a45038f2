"""Switch-Transformer-style MoE GPT-2: training and serving.

Counterpart of ``deepspeed_tpu/models/gpt2_moe.py``. Every other block's
dense MLP (the odd blocks, 0-indexed) is replaced by a top-k-gated expert
bank (``moe/``); the rest is the plain GPT-2. The odd blocks keep their
dense ``fc_*`` weights, as in JAX: no gradient reaches them, and AdamW
still decays them.

The layer walk is the JAX one over *pairs*: the dense block, then the odd
block's attention and its MoE MLP. With ``sparse_attention`` both halves
of a pair attend through ``SparseSelfAttention`` (GPT-2's ``_attention``),
as the JAX ``_attn_sublayer`` does; prefill and decode stay dense, and a
sparse model is not served (GPT-2's ``init_cache`` raises), as in JAX.
A config with ``dropout`` raises: the JAX trunk passes no rng to its
blocks and so trains such a config without dropout. ``remat`` applies its
policy per pair (``models/common.py`` ``remat_call``), as the JAX model
does; the gate's
random draws (top-2's second keep, ``RSample``) are made before the pair,
so a recompute routes as the forward did. The aux loss is the mean of the pairs' ``l_aux``, and
``loss`` adds ``aux_loss_coef`` times it to the chunked cross entropy.

Under the engine, ``expert_groups`` (set by the engine) carries the
process groups: the gates route over the global micro-batch and the
experts exchange tokens over the expert-parallel group
(``moe/sharded_moe.py``); with ``ep_size`` > 1 this rank holds its
``num_experts / ep_size`` experts of every bank. A tag holds the MoE
layers stacked as the JAX tree does (``moe.experts.wi`` (n_moe, E, D, H)
and so on; ``stacked_modules``).

Serving is GPT-2's ``prefill`` and ``decode_step`` over the same KV cache,
each odd layer finishing through its expert bank (``_layer_finish``),
graph-safe (the position stays on the device, capacities are host
integers of static shapes). Serving is one process: with ``ep_size`` > 1
``init_cache`` raises (expert-parallel serving is a later slice).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.models.common import init_pieces, remat_call
from deepspeed_tpu_torch.models.gpt2 import BLOCK_KEYS, GPT2Config, GPT2Model
from deepspeed_tpu_torch.moe.layer import MoE, default_ep_rank


class MoEGPT2(GPT2Model):
    """GPT-2 with MoE MLPs on the odd blocks (1, 3, ...)."""

    # module lists a tag holds stacked over their layers, as the JAX tree
    stacked_modules = ("moe",)

    def __init__(self, config: GPT2Config, num_experts: int = 8, ep_size: int = 1,
                 k: int = 1, capacity_factor: float = 1.25, eval_capacity_factor: float = 1.0,
                 min_capacity: int = 4, drop_tokens: bool = True, aux_loss_coef: float = 0.01,
                 ep_rank: Optional[int] = None):
        super().__init__(config)
        if config.parallel_residual:
            raise NotImplementedError("MoEGPT2 does not implement parallel_residual")
        if config.attention_layers and "local" in config.attention_layers:
            raise NotImplementedError("MoEGPT2 does not implement GPT-Neo local attention "
                                      "layers")
        if config.dropout:
            # the JAX _moe_trunk passes rng=None to every dense block, so a
            # dropout config trains there with no dropout at all; the port
            # does not copy that silent drop
            raise NotImplementedError(
                "MoEGPT2 with dropout: the reference MoE trunk silently trains without "
                "dropout (it passes no rng to its blocks), and the port refuses it rather "
                "than copy that")
        if config.n_layer % 2:
            raise ValueError(f"MoEGPT2 pairs a dense block with a MoE block: n_layer "
                             f"{config.n_layer} must be even")
        self.moe_every = 2
        self.num_experts, self.ep_size = num_experts, ep_size
        self.ep_rank = default_ep_rank(ep_size) if ep_rank is None else ep_rank
        self.aux_loss_coef = aux_loss_coef
        self.moe = nn.ModuleList(
            MoE(hidden_size=config.n_embd, num_experts=num_experts, ep_size=ep_size, k=k,
                capacity_factor=capacity_factor, eval_capacity_factor=eval_capacity_factor,
                min_capacity=min_capacity, drop_tokens=drop_tokens, ep_rank=self.ep_rank)
            for _ in range(config.n_layer // self.moe_every))
        # the engine's utils.groups.ExpertGroups; None: this process alone
        self.expert_groups = None

    @property
    def n_pairs(self) -> int:
        return self.config.n_layer // self.moe_every

    def expert_module_names(self):
        """The modules whose parameters are split over the expert axis."""
        return [f"moe.{p}.experts" for p in range(self.n_pairs)]

    # ---------------------------------------------------------------- params
    def param_chunks(self, generator: torch.Generator, chunk: Optional[int] = None):
        """GPT-2's random pieces, then each MoE layer's (``MoE.param_chunks``:
        the experts drawn for every expert, this rank's kept); the
        inherited ``init_params`` assembles them."""
        yield from super().param_chunks(generator, chunk)
        pieces = init_pieces(generator, chunk)
        for p, layer in enumerate(self.moe):
            yield from layer.param_chunks(pieces, f"moe.{p}.")

    # --------------------------------------------------------------- compute
    def _attn_proj(self, x, w, attn):
        """An odd block's projection and residual after its attention, and
        its MLP's layer norm: (x, the MoE's input)."""
        B, T, D = x.shape
        x = x + (attn.reshape(B, T, D) @ w.proj_w.to(x.dtype) + w.proj_b.to(x.dtype))
        return x, self._layer_norm(x, w.ln2_g, w.ln2_b)

    def _attn_half(self, x, blk, rope=None):
        """The odd block's attention sublayer and its MLP's layer norm;
        ``rope``: the rotary tables of positions 0..T-1 (made here when
        None). A MoEGPT2 has no local layer, so the layer's index does not
        reach the attention."""
        with self._gathered(blk) as w:
            if rope is None:
                rope = self._rope_tables(torch.arange(x.shape[1], device=x.device))
            q, k, v = self._block_qkv(x, w, rope)
            return self._attn_proj(x, w, self._attention(q, k, v, 0))

    def _pair(self, x, p: int, train: bool, noise, rope):
        """Dense block 2p, then block 2p + 1 with MoE layer p as its MLP."""
        n = self.moe_every * p
        x = self._block(x, self.blocks[n], n, rope)
        x, h = self._attn_half(x, self.blocks[n + 1], rope)
        out, l_aux = self.moe[p](h, train, groups=self.expert_groups, noise=noise,
                                 gathered=self._gathered)
        return x + out, l_aux

    def _moe_blocks(self, input_ids, generator=None, train: bool = False):
        """(B, T) → (hidden before the final layer norm, mean aux loss)."""
        x = self._embed(input_ids)
        g = self.expert_groups
        tokens = input_ids.numel() * (1 if g is None else g.world)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        rope = self._rope_tables(torch.arange(input_ids.shape[1], device=x.device))
        for p, layer in enumerate(self.moe):
            # drawn here, so a recomputed pair routes as its forward did
            noise = layer.gate.draws(generator, tokens, x.device, train)
            x, l_aux = remat_call(self.config.remat, self._pair, x, p, train, noise, rope)
            aux = aux + l_aux
        return x, aux / self.n_pairs

    def hidden_states(self, input_ids):
        x, _ = self._moe_blocks(input_ids)
        with self._gathered(self) as top:
            return self._layer_norm(x, top.lnf_g, top.lnf_b)

    def apply(self, input_ids):
        """(B, T) → logits (B, T, V) fp32 through the MoE trunk (the dense
        walk would run the odd blocks' untrained MLPs)."""
        x, _ = self._moe_blocks(input_ids)
        return self._lm_logits(x)

    forward = apply

    def loss(self, batch, generator: Optional[torch.Generator] = None,
             loss_weight: Optional[torch.Tensor] = None):
        """Chunked next-token cross entropy + ``aux_loss_coef`` x the mean
        aux loss. ``generator``: the gates' random draws (the engine's,
        seeded from its seed and step). ``loss_weight``: the weight the
        engine multiplies this rank's loss by (its share of a loss mask's
        tokens); the aux term is divided by it, so after the engine's
        weighting and mean over ranks it is the global aux loss."""
        ids = batch["input_ids"] if isinstance(batch, dict) else batch
        x, aux = self._moe_blocks(ids, generator, train=True)
        if loss_weight is not None:
            aux = aux / loss_weight
        with self._gathered(self) as top:
            return self.loss_stage(top, x, batch) + self.aux_loss_coef * aux

    # ------------------------------------------------------------- inference
    def init_cache(self, batch_size: int, max_len: int, device=None):
        """GPT-2's KV cache; ``prefill`` and ``decode_step`` are GPT-2's
        walk, each odd layer finishing through its expert bank. Serving is
        one process: expert-parallel serving is a later slice."""
        if self.ep_size > 1:
            raise NotImplementedError("expert-parallel serving (ep_size > 1): later slice of "
                                      "the port")
        return super().init_cache(batch_size, max_len, device=device)

    def _layer_finish(self, n: int, x, w, attn):
        if n % self.moe_every == 0:
            return self._block_finish(x, w, attn)
        x, h = self._attn_proj(x, w, attn)
        out, _ = self.moe[n // self.moe_every](h, train=False, gathered=self._gathered)
        return x + out


def params_from_jax(np_params: Mapping[str, Any], config: GPT2Config, **moe_kwargs) -> MoEGPT2:
    """A MoEGPT2 holding the JAX package's MoE GPT-2 params (numpy arrays):
    GPT-2's leaves as ``gpt2.params_from_jax`` maps them, and the ``moe``
    subtree, stacked over the MoE layers, one MoE module each (this rank's
    experts of each bank when ``ep_size`` > 1). ``moe_kwargs``: MoEGPT2's
    keyword arguments. The copy is exact."""
    t = lambda a: torch.tensor(np.asarray(a))
    model = MoEGPT2(config, **moe_kwargs)
    sd = {k: t(v) for k, v in np_params.items() if k not in ("blocks", "moe")}
    for key in BLOCK_KEYS:
        stacked = np.asarray(np_params["blocks"][key])
        for n in range(config.n_layer):
            sd[f"blocks.{n}.{key}"] = t(stacked[n])

    def walk(tree, prefix):
        for key, leaf in tree.items():
            if isinstance(leaf, Mapping):
                yield from walk(leaf, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", np.asarray(leaf)

    local = model.num_experts // model.ep_size
    lo = model.ep_rank * local
    for name, stacked in walk(np_params["moe"], ""):
        for p in range(model.n_pairs):
            leaf = stacked[p]
            if name.startswith("experts."):
                leaf = leaf[lo:lo + local]
            sd[f"moe.{p}.{name}"] = t(leaf)
    model.load_state_dict(sd, assign=True)
    return model
