"""Megatron 2D (tp × pp) checkpoint grid reshaping.

Counterpart of ``deepspeed_tpu/checkpoint/meg_2d.py`` (and of the
reference's ``deepspeed/checkpoint/reshape_meg_2d.py``): a (pp, tp) grid of
state-dict shards is reshaped to a new (pp', tp') grid by merging and
splitting tensor shards along each parameter's partition dimension. Shards
are ``{name: tensor}`` dicts; numpy arrays become tensors on entry, and a
tensor keeps its type and device.

The partition rules follow Megatron's names: row-parallel weights (the
attention output ``self_attention.dense.weight``, the MLP's
``mlp.dense_4h_to_h.weight``) concatenate on dim 1; replicated tensors
(layer norms, the biases of row-parallel layers, the position table, the
MoE router) must agree across tp and pass through; everything else is
partitioned on dim 0 (column-parallel weights and their biases, the
vocab-sharded word embedding).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

# replicated across tp: merged by identity
SEQUENTIAL_LAYERS = [
    "input_layernorm.weight", "input_layernorm.bias",
    "post_attention_layernorm.weight", "post_attention_layernorm.bias",
    "final_layernorm.weight", "final_layernorm.bias",
    "self_attention.dense.bias", "mlp.dense_4h_to_h.bias",
    "attention.dense.bias",
    # Megatron's position embedding is a plain nn.Embedding (only the word
    # embedding is vocab-parallel)
    "position_embeddings.weight",
    # the MoE router is a plain Linear outside the tp-partitioned regions: a
    # dim-0 concat would give a (tp * E, D) gate to an E-expert model
    "deepspeed_moe.gate.wg.weight",
]
# a bare final-norm file's keys: replicated, matched by equality only (a
# suffix match on "weight" would take every weight as replicated)
SEQUENTIAL_EXACT = ["weight", "bias"]
# the dims other than 0 that a partitioned tensor concatenates on
LAYER_CONCAT_DIM = {"self_attention.dense.weight": 1,
                    "attention.dense.weight": 1,
                    "mlp.dense_4h_to_h.weight": 1}


def _endswith_any(name: str, suffixes) -> bool:
    return any(name == s or name.endswith("." + s) for s in suffixes)


def partition_dim(name: str) -> Optional[int]:
    """None: replicated across tp; else the dim the tp shards split."""
    if name in SEQUENTIAL_EXACT or _endswith_any(name, SEQUENTIAL_LAYERS):
        return None
    for key, dim in LAYER_CONCAT_DIM.items():
        if name == key or name.endswith("." + key):
            return dim
    return 0


class meg_2d_parallel_map:
    """(pp, tp) → a list of payloads (the reference's ``reshape_meg_2d.py``
    map)."""

    def __init__(self, pp_degree: int, tp_degree: int):
        self.pp_degree = int(pp_degree)
        self.tp_degree = int(tp_degree)
        self.map: Dict[str, List] = {}

    def simple_init(self):
        for pp in range(self.pp_degree):
            for tp in range(self.tp_degree):
                self.add_data(pp, tp, [pp * self.tp_degree + tp])

    def _key(self, pp: int, tp: int) -> str:
        self._validate_indices(pp, tp)
        return f"{pp},{tp}"

    def _validate_indices(self, pp: int, tp: int):
        assert 0 <= pp < self.pp_degree, f"pp {pp} out of [0, {self.pp_degree})"
        assert 0 <= tp < self.tp_degree, f"tp {tp} out of [0, {self.tp_degree})"

    def add_data(self, pp_index: int, tp_index: int, data) -> None:
        key = self._key(pp_index, tp_index)
        self.map.setdefault(key, [])
        self.map[key].extend(data if isinstance(data, list) else [data])

    def get_data(self, pp_index: Optional[int] = None, tp_index: Optional[int] = None) -> List:
        pps = [pp_index] if pp_index is not None else range(self.pp_degree)
        tps = [tp_index] if tp_index is not None else range(self.tp_degree)
        out = []
        for pp in pps:
            for tp in tps:
                out.extend(self.map.get(self._key(pp, tp), []))
        return out


def as_tensor(x: Any) -> torch.Tensor:
    """A tensor (detached, on its device, in its type) or an array (a CPU
    tensor)."""
    return x.detach() if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def merge_tp_shards(shards: List[Dict[str, Any]]) -> Dict[str, torch.Tensor]:
    """The tp shards of one stage → its unsharded state dict. A replicated
    tensor that differs across the shards (beyond ``allclose``) raises."""
    out = {}
    for name in shards[0]:
        dim = partition_dim(name)
        parts = [as_tensor(s[name]) for s in shards]
        if dim is None or parts[0].ndim == 0:
            for p in parts[1:]:
                if not torch.allclose(parts[0].double(), p.double()):
                    raise ValueError(f"replicated tensor {name} differs across tp shards")
            out[name] = parts[0]
        else:
            out[name] = torch.cat(parts, dim=dim)
    return out


def split_tp_shards(full: Dict[str, Any], tp_degree: int) -> List[Dict[str, torch.Tensor]]:
    """Inverse of :func:`merge_tp_shards`: the unsharded stage → ``tp_degree``
    shards, each a tensor of its own (``torch.save`` of a view would write
    the whole storage)."""
    shards: List[Dict[str, torch.Tensor]] = [dict() for _ in range(tp_degree)]
    for name, arr in full.items():
        arr = as_tensor(arr)
        dim = partition_dim(name)
        if dim is None or arr.ndim == 0:
            for s in shards:
                s[name] = arr
        else:
            if arr.shape[dim] % tp_degree:
                raise ValueError(f"{name} dim {dim} size {arr.shape[dim]} not divisible by "
                                 f"tp {tp_degree}")
            for t, piece in enumerate(torch.chunk(arr, tp_degree, dim=dim)):
                shards[t][name] = piece.clone()
    return shards


def reshape_meg_2d_parallel(old_pp: int, old_tp: int, new_pp: int, new_tp: int,
                            get_shard: Callable[[int, int], Dict],
                            layers_per_pp: Optional[List[List[str]]] = None):
    """Reshape an (old_pp, old_tp) grid to (new_pp, new_tp).

    ``get_shard(pp, tp)`` returns that coordinate's ``{name: tensor}``
    state. Each stage is merged over tp, the pp stages are grouped (their
    keys are disjoint, as in Megatron's layer files; a pp split raises),
    and the result is split to ``new_tp``. Returns a
    :class:`meg_2d_parallel_map` whose payloads are state dicts."""
    if new_pp != old_pp and old_pp % new_pp and new_pp % old_pp:
        raise ValueError(f"pp reshape {old_pp}→{new_pp} must nest")
    merged = [merge_tp_shards([get_shard(pp, tp) for tp in range(old_tp)])
              for pp in range(old_pp)]
    if new_pp == old_pp:
        stages = merged
    elif old_pp % new_pp == 0:
        k = old_pp // new_pp
        stages = []
        for i in range(new_pp):
            d = {}
            for j in range(k):
                d.update(merged[i * k + j])
            stages.append(d)
    else:
        raise NotImplementedError(f"pp split {old_pp}→{new_pp} needs a per-layer file "
                                  "mapping; merge to pp=1, then partition with the pipeline "
                                  "module instead")
    out = meg_2d_parallel_map(new_pp, new_tp)
    for pp, stage in enumerate(stages):
        for tp, shard in enumerate(split_tp_shards(stage, new_tp)):
            out.add_data(pp, tp, [shard])
    return out
