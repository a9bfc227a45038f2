"""Elastic batch math.

Counterpart of ``deepspeed_tpu/elasticity/elasticity.py`` (and of the
reference's ``deepspeed/elasticity/elasticity.py``), the same candidates,
chip counts and choice. The contract: pick ONE global train batch size
such that many chip counts in [min_gpus, max_gpus] can run it exactly
(global = micro_batch × grad_accum × world), so nodes can join/leave without
changing the optimization trajectory.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

from deepspeed_tpu_torch.elasticity.config import ElasticityConfig, ElasticityError


def _divisors(n: int) -> List[int]:
    out = []
    d = 1
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            if d != n // d:
                out.append(n // d)
        d += 1
    return sorted(out)


def get_candidate_batch_sizes(micro_batches: Sequence[int], max_batch: int) -> List[int]:
    """All global batch sizes ≤ max_batch expressible as mb × 2^k × (1 or 3 or 5)
    for some candidate micro-batch.

    Highly-composite multiples keep the set small while giving each candidate
    batch many valid (micro, gas, world) factorizations — same intent as the
    reference's power-of-two enumeration (elasticity.py:27).
    """
    candidates = set()
    for mb in micro_batches:
        base = mb
        while base <= max_batch:
            for odd in (1, 3, 5):
                if base * odd <= max_batch:
                    candidates.add(base * odd)
            base *= 2
    return sorted(candidates)


def get_compatible_chip_counts(batch: int,
                               micro_batches: Sequence[int],
                               min_gpus: int,
                               max_gpus: int,
                               multiple_of: int = 1) -> List[int]:
    """World sizes w ∈ [min,max] (w % multiple_of == 0) such that batch is
    exactly micro × gas × w for some candidate micro-batch.

    v0.2 semantics: ``multiple_of = num_gpus_per_node × model_parallel_size``
    keeps full hosts and whole MP groups (reference _get_compatible_gpus_v02).
    """
    valid = []
    for w in _divisors(batch):
        if not (min_gpus <= w <= max_gpus) or w % multiple_of:
            continue
        per_step = batch // w
        if any(per_step % mb == 0 for mb in micro_batches):
            valid.append(w)
    return valid


def _best_batch(config: ElasticityConfig) -> Tuple[int, List[int]]:
    multiple_of = 1
    if config.version >= 0.2:
        multiple_of = config.num_gpus_per_node * config.model_parallel_size
    best: Tuple[int, List[int]] = (0, [])
    for batch in get_candidate_batch_sizes(config.micro_batch_sizes,
                                           config.max_train_batch_size):
        gpus = get_compatible_chip_counts(batch, config.micro_batch_sizes,
                                          config.min_gpus, config.max_gpus,
                                          multiple_of)
        if not gpus:
            continue
        better = len(gpus) > len(best[1])
        tie = len(gpus) == len(best[1])
        prefer = (batch > best[0]) if config.prefer_larger_batch \
            else (batch < best[0] or best[0] == 0)
        if better or (tie and prefer):
            best = (batch, gpus)
    if best[0] == 0:
        raise ElasticityError(
            f"no batch ≤ {config.max_train_batch_size} is compatible with any chip "
            f"count in [{config.min_gpus}, {config.max_gpus}] "
            f"given micro_batch_sizes={config.micro_batch_sizes}")
    return best


def elasticity_enabled(ds_config: Dict) -> bool:
    return bool(ds_config.get("elasticity", {}).get("enabled", False))


def compute_elastic_config(ds_config, target_deepspeed_version: str = None,
                           world_size: int = 0, return_microbatch: bool = False):
    """Resolve the elastic schedule.

    Return contract mirrors reference compute_elastic_config:233: a 2-tuple
    ``(final_batch_size, valid_chip_counts)``, widened to a 3-tuple with the
    micro-batch when ``world_size > 0`` (:361) or when ``return_microbatch``
    is set (:363-376). Grad-accum steps = final_batch // (world * micro).
    """
    if isinstance(ds_config, str):
        with open(ds_config) as f:
            ds_config = json.load(f)
    block = ds_config.get("elasticity")
    if block is None:
        raise ElasticityError("ds_config has no 'elasticity' block")
    config = ElasticityConfig.from_dict(block)
    if not config.enabled:
        raise ElasticityError("elasticity.enabled is false")

    if not config.ignore_non_elastic_batch_info:
        clashing = [k for k in ("train_batch_size", "train_micro_batch_size_per_gpu",
                                "gradient_accumulation_steps") if k in ds_config]
        if clashing:
            raise ElasticityError(
                f"batch keys {clashing} conflict with elasticity; remove them or set "
                "elasticity.ignore_non_elastic_batch_info=true")

    final_batch, valid_gpus = _best_batch(config)

    if world_size > 0:
        if world_size not in valid_gpus:
            raise ElasticityError(
                f"world size {world_size} incompatible with elastic batch {final_batch}; "
                f"valid chip counts: {valid_gpus}")
        per_step = final_batch // world_size
        # largest candidate micro-batch that divides this world's share
        micro = max(mb for mb in config.micro_batch_sizes if per_step % mb == 0)
        return final_batch, valid_gpus, micro

    if return_microbatch:
        # no world size yet: the largest candidate that divides the batch
        micro = max(mb for mb in config.micro_batch_sizes if final_batch % mb == 0)
        return final_batch, valid_gpus, micro
    return final_batch, valid_gpus


def validate_elastic_config_from_script_args(args) -> None:
    """Runner-side preflight for --elastic_training (reference runner.py:380)."""
    cfg_path = None
    for i, a in enumerate(args.user_args):
        if a == "--deepspeed_config" and i + 1 < len(args.user_args):
            cfg_path = args.user_args[i + 1]
        elif a.startswith("--deepspeed_config="):
            cfg_path = a.split("=", 1)[1]
    if cfg_path is None:
        raise ElasticityError("--elastic_training requires --deepspeed_config in script args")
    final_batch, valid = compute_elastic_config(cfg_path)
    from deepspeed_tpu_torch.utils.logging import logger

    logger.info(f"elastic config ok: batch={final_batch}, valid chip counts={valid}")
