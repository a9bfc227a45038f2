"""Rank topology: the rank ↔ coordinate grid and the data-parallel groups.

Counterpart of ``deepspeed_tpu/parallel/topology.py`` (the reference's
``deepspeed/runtime/pipe/topology.py``). :class:`ProcessTopology` is the
same integer math over named axes. The JAX package's ``ParallelGrid`` reads
axis sizes from a device mesh; here the grid is built over
``torch.distributed`` process groups with two axes, ``data`` and
``expert`` inside it (the JAX axis order: rank ``d * ep + x``). The batch
is split over both, as ``expert`` is one of the JAX package's
data-parallel axes, so the data-parallel group is the whole world and ZeRO
partitions state over it; the ranks that share ``d`` split the experts of
a MoE layer between them (``utils/groups.py``). Pipe, tensor and sequence
groups are later slices of the port.
"""

from __future__ import annotations

import itertools
from collections import namedtuple
from typing import List, Sequence

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.utils import groups

DATA_AXIS = "data"
EXPERT_AXIS = "expert"


class ProcessTopology:
    """Cartesian rank ↔ coordinate mapping over named axes, the last axis
    varying fastest (reference topology.py:12)."""

    def __init__(self, axes: Sequence[str], dims: Sequence[int]):
        if len(axes) != len(dims):
            raise ValueError(f"{len(axes)} axes for {len(dims)} dims")
        self.axes = list(axes)
        self.dims = [int(d) for d in dims]
        self.ProcessCoord = namedtuple("ProcessCoord", self.axes)
        strides, s = [], 1
        for d in reversed(self.dims):
            strides.append(s)
            s *= d
        self._strides = strides[::-1]

    def world_size(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def get_rank(self, **coord_kwargs) -> int:
        if sorted(coord_kwargs) != sorted(self.axes):
            raise ValueError(f"get_rank() needs all axes {self.axes}, got {list(coord_kwargs)}")
        rank = 0
        for axis, stride, dim in zip(self.axes, self._strides, self.dims):
            c = coord_kwargs[axis]
            if not 0 <= c < dim:
                raise ValueError(f"{axis}={c} outside [0, {dim})")
            rank += stride * c
        return rank

    def get_coord(self, rank: int):
        return self.ProcessCoord(*((rank // s) % d for s, d in zip(self._strides, self.dims)))

    def get_axis_names(self) -> List[str]:
        return list(self.axes)

    def get_dim(self, axis: str) -> int:
        return self.dims[self.axes.index(axis)] if axis in self.axes else 1

    def get_rank_repr(self, rank: int, omit_axes=("data",), inner_sep="_", outer_sep="-") -> str:
        coord = self.get_coord(rank)
        return outer_sep.join(f"{ax}{inner_sep}{getattr(coord, ax):02d}"
                              for ax in self.axes if ax not in omit_axes)

    def filter_match(self, **filter_kwargs) -> List[int]:
        """All ranks whose coordinates match the given axis=value pairs."""
        return [r for r in range(self.world_size())
                if all(getattr(self.get_coord(r), ax) == v for ax, v in filter_kwargs.items())]

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """Groups of ranks that differ only along ``axis`` (reference :127)."""
        if axis not in self.axes:
            return []
        others = [a for a in self.axes if a != axis]
        return [[self.get_rank(**dict(zip(others, combo)), **{axis: i})
                 for i in range(self.get_dim(axis))]
                for combo in itertools.product(*(range(self.get_dim(a)) for a in others))]

    def __str__(self):
        return f"ProcessTopology(axes={self.axes}, dims={self.dims})"


class ParallelGrid:
    """The data-parallel part of the reference's ``PipelineParallelGrid``
    over process groups: the world as ``data`` x ``expert``, the expert
    axis of size ``ep_size`` (which must divide the world)."""

    def __init__(self, ep_size: int = 1):
        world = comm.get_world_size()
        if ep_size < 1 or world % ep_size:
            raise ValueError(f"world {world} not divisible by the expert axis {ep_size}")
        self.topo = ProcessTopology([DATA_AXIS, EXPERT_AXIS], [world // ep_size, ep_size])
        self.global_rank = comm.get_rank()
        self._dp_group = comm.get_world_group()
        self.expert_groups = groups.initialize(ep_size)

    def get_data_parallel_world_size(self) -> int:
        return self.topo.world_size()

    def get_data_parallel_rank(self) -> int:
        return self.global_rank

    def get_data_parallel_group(self):
        return self._dp_group

    def get_expert_parallel_world_size(self) -> int:
        return self.topo.get_dim(EXPERT_AXIS)

    def get_expert_parallel_rank(self) -> int:
        return self.topo.get_coord(self.global_rank).expert

    def get_expert_parallel_group(self):
        """The ranks that share this rank's ``data`` coordinate (None for one)."""
        return self.expert_groups.ep_group

    def get_expert_data_parallel_group(self):
        """The ranks that share this rank's ``expert`` coordinate (None for one)."""
        return self.expert_groups.edp_group

    def get_model_parallel_world_size(self) -> int:
        return 1
