"""Expert-parallel process groups.

Counterpart of ``deepspeed_tpu/utils/groups.py`` (the reference's
``deepspeed/utils/groups.py``). The JAX package keeps the rank lists only:
its groups are slices of the mesh's ``expert`` axis. Here they are
``torch.distributed`` groups, one per list, made by :func:`initialize`.

The grid is the JAX mesh's order, ``expert`` inside ``data``: rank
``d * ep + x``. An expert-parallel group holds the ``ep`` ranks that share
``d`` (they split the experts between them); an expert-data-parallel group
holds the ranks that share ``x`` (they hold the same experts). The batch is
split over every rank, as ``expert`` is one of the JAX package's
data-parallel axes, so the data-parallel group is the whole world.

A group of one rank is not made: its collectives would be copies, and the
MoE layer issues none where the JAX program has none (``expert`` 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.utils.logging import log_dist


def _get_expert_parallel_ranks(world_size: int, model_parallel_size: int,
                               expert_parallel_size: int
                               ) -> Tuple[List[List[int]], List[List[int]]]:
    """(expert-parallel rank lists, expert-data-parallel rank lists).

    The data-parallel ranks of one model-parallel position are
    ``mp, mp + m, mp + 2m, ...``; each run of ``e`` consecutive ones is an
    expert-parallel group, and the ranks at the same offset of every run
    are an expert-data-parallel group. W=16, m=2, e=4 gives EP [0,2,4,6],
    [8,10,12,14], [1,3,5,7], [9,11,13,15] and EDP [0,8], [2,10], [4,12],
    [6,14], [1,9], [3,11], [5,13], [7,15] (the reference's example)."""
    ep_lists, edp_lists = [], []
    for mp in range(model_parallel_size):
        dp = list(range(mp, world_size, model_parallel_size))
        ep_lists += [dp[i:i + expert_parallel_size]
                     for i in range(0, len(dp), expert_parallel_size)]
        edp_lists += [dp[i::expert_parallel_size] for i in range(expert_parallel_size)]
    return ep_lists, edp_lists


@dataclasses.dataclass(frozen=True)
class ExpertGroups:
    """This rank's place in the expert grid and its groups (None where a
    group would hold one rank)."""
    world: int                    # the data-parallel world: every rank
    rank: int
    ep_size: int
    ep_rank: int                  # x: which E/ep experts this rank holds
    world_group: Any              # gating's all-gather
    ep_group: Any                 # the dispatch's all-to-all
    edp_group: Any                # the expert gradients' reduction
    ep_ranks: Tuple[int, ...]
    edp_ranks: Tuple[int, ...]


# ep_size → (the default group the groups were made in, ExpertGroups)
_GROUPS: Dict[int, Tuple[Any, ExpertGroups]] = {}


def initialize(ep_size: int = 1, mpu=None) -> ExpertGroups:
    """Make (or reuse) the expert-parallel and expert-data-parallel groups
    of ``ep_size`` over the default process group; every rank calls it, and
    each calls ``new_group`` for every list in the same order. Without a
    process group the world is one rank and nothing is made."""
    if mpu is not None:
        raise NotImplementedError("expert groups with model parallelism (mpu): later slice "
                                  "of the port")
    world, rank = comm.get_world_size(), comm.get_rank()
    if ep_size < 1 or world % ep_size:
        raise ValueError(f"world {world} not divisible by the expert-parallel size {ep_size}")
    default = comm.get_world_group()
    held = _GROUPS.get(ep_size)
    if held is not None and held[0] is default:
        return held[1]
    ep_lists, edp_lists = _get_expert_parallel_ranks(world, 1, ep_size)
    made = {}
    for ranks in ep_lists + edp_lists:
        if len(ranks) == 1:
            continue
        group = default if len(ranks) == world else comm.new_group(ranks)
        if rank in ranks:
            made[tuple(ranks)] = group
    ep_ranks = next(tuple(r) for r in ep_lists if rank in r)
    edp_ranks = next(tuple(r) for r in edp_lists if rank in r)
    groups = ExpertGroups(world=world, rank=rank, ep_size=ep_size,
                          ep_rank=ep_ranks.index(rank),
                          world_group=default if world > 1 else None,
                          ep_group=made.get(ep_ranks), edp_group=made.get(edp_ranks),
                          ep_ranks=ep_ranks, edp_ranks=edp_ranks)
    _GROUPS[ep_size] = (default, groups)
    log_dist(f"expert groups: ep_size={ep_size}, {len(ep_lists)} expert-parallel group(s) "
             f"over {world} rank(s)", ranks=[0])
    return groups


def _get(ep_size: Optional[int]) -> ExpertGroups:
    if ep_size is None:
        if len(_GROUPS) != 1:
            raise KeyError("name the expert-parallel size: groups of "
                           f"{sorted(_GROUPS)} are initialized")
        ep_size = next(iter(_GROUPS))
    if ep_size not in _GROUPS:
        raise KeyError(f"expert groups of ep_size {ep_size} not initialized: call "
                       "groups.initialize()")
    return _GROUPS[ep_size][1]


def _size(group_name) -> Optional[int]:
    """``"ep_size_4"`` (the reference's group names) or 4 → 4."""
    if group_name is None or isinstance(group_name, int):
        return group_name
    return int(str(group_name).rsplit("_", 1)[-1])


def get_expert_parallel_group(group_name=None):
    return _get(_size(group_name)).ep_group


def get_expert_data_parallel_group(group_name=None):
    return _get(_size(group_name)).edp_group


def get_expert_parallel_world_size(group_name=None) -> int:
    return _get(_size(group_name)).ep_size if _GROUPS else 1


def get_expert_parallel_rank(group_name=None) -> int:
    return _get(_size(group_name)).ep_rank if _GROUPS else 0


def get_max_expert_size() -> int:
    return max(_GROUPS, default=1)


def get_data_parallel_world_size() -> int:
    return comm.get_world_size()
