"""Seqlen curriculum: a difficulty d trains on the first d tokens.

Counterpart of ``deepspeed_tpu/runtime/data_pipeline/data_sampling.py``.
The truncation runs on the host before the batch goes to the card: numpy
arrays and host tensors are sliced as they come (a tensor already on the
card is sliced there, since copying it back would cost more than the cut).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import logger


def _as_array(x):
    return x if torch.is_tensor(x) else np.asarray(x)


def apply_seqlen_curriculum(batch: Any, difficulty: int,
                            truncate_keys=("input_ids", "labels", "loss_mask",
                                           "attention_mask", "position_ids")) -> Any:
    """Cut the token dimension (dim 1) of a batch to ``difficulty``.

    Dict batches: every known sequence key is cut. Tuples and lists: the
    elements whose dim 1 equals the first element's (targets of another
    width are left alone). A bare array is cut when it has 2 dims or more."""
    def cut(x):
        x = _as_array(x)
        if x.ndim >= 2 and x.shape[1] > difficulty:
            return x[:, :difficulty]
        return x

    if isinstance(batch, dict):
        return {k: (cut(v) if k in truncate_keys else v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        first = _as_array(batch[0])
        seq_len = first.shape[1] if first.ndim >= 2 else None
        elems = [cut(v) if seq_len is not None and _as_array(v).ndim >= 2
                 and _as_array(v).shape[1] == seq_len else v
                 for v in batch]
        if hasattr(batch, "_fields"):          # namedtuple
            return type(batch)(*elems)
        return type(batch)(elems)
    return cut(batch)


def curriculum_config_from_ds(pd: Dict) -> Dict:
    """The seqlen-truncation curriculum of a ds_config: the legacy top-level
    ``curriculum_learning`` block, else the ``seqlen`` metric (or a flat
    schedule) of ``data_efficiency.data_sampling.curriculum_learning``.
    Metrics with analyzer index files drive the sampler instead, so they
    give no truncation."""
    legacy = pd.get("curriculum_learning", {})
    if legacy.get("enabled"):
        return legacy
    de = pd.get("data_efficiency", {})
    ds = de.get("data_sampling", {})
    cl = ds.get("curriculum_learning", {})
    if de.get("enabled", True) and ds.get("enabled", True) and cl.get("enabled"):
        metrics = cl.get("curriculum_metrics", {})
        file_based = {n for n, m in metrics.items()
                      if "index_to_sample_path" in m
                      or m.get("clustering_type") == "single_cluster"}
        if "seqlen" in metrics and "seqlen" not in file_based:
            m = dict(metrics["seqlen"])
            m.setdefault("curriculum_type", "seqlen")
            return {**m, "enabled": True}
        if metrics and not file_based:
            logger.warning(f"curriculum metrics {sorted(metrics)} unsupported for "
                           "truncation (only 'seqlen'); curriculum truncation disabled")
            return {}
        if "min_difficulty" in cl:      # a flat schedule block
            return cl
    return {}
