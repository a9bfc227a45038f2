"""ZeRO partitioning: where every parameter's state sits, per stage.

Counterpart of ``deepspeed_tpu/runtime/zero/partition.py`` (``plan_sharding``
and ``partition_report``). The JAX package states a placement per tensor
and lets XLA generate the collectives; the port has no XLA, so it lays the
state out the reference DeepSpeed way (``zero/stage_1_and_2.py``,
``zero/stage3.py``): flat, padded buffers partitioned over the
data-parallel group, with the collectives issued by the engine.

  stage 0  params, gradients, fp32 masters and optimizer state whole
  stage 1  + fp32 masters and optimizer state partitioned; the whole
           gradients reduce-scattered into the partition at the boundary
  stage 2  + gradients reduce-scattered into the partition every microbatch,
           each unit's as soon as they are complete
  stage 3  + compute-type parameters partitioned, gathered per module

The layout is a list of *units*, one per module: each a flat buffer of
the module's own parameters laid end to end (each at an offset aligned to
``ALIGN`` elements) and padded to a multiple of ``ALIGN * world``; rank
``r`` owns the ``r``-th of ``world`` equal shards of every unit. A unit is
what the engine allocates, reduces and gathers at once: its gradient
buffer lives from its first gradient to its reduction. At stage 3 the
parameters below ``stage3_param_persistence_threshold`` elements form one
more unit, whose compute-type parameters stay whole on every rank (the JAX
plan's ``min_size``); every other unit's are gathered before its module
runs. Padding is zero and stays zero: no gradient reaches it, so no
optimizer moves it, and no checkpoint holds it.

Where the two plans differ: the threshold is held against each layer's
tensor here, as the reference holds it against each parameter, where the
JAX package holds it against the layer-stacked tensor; and a tensor none of
whose dims divides by the world is partitioned here (padding absorbs the
remainder), where the JAX plan keeps it whole and warns.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

# elements between parameter offsets: 128 bytes of bf16, so every view a
# matmul reads starts aligned
ALIGN = 64


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class ParamPlacement:
    name: str
    shape: Tuple[int, ...]
    numel: int
    unit: int                 # index into ZeroPlan.units
    offset: int               # element offset in the unit's flat buffer
    partitioned: bool         # the compute-type parameter (stage 3)
    master_partitioned: bool  # fp32 master and optimizer state (stage >= 1)
    grad_partitioned: bool    # gradient after the boundary (stage >= 2)


@dataclasses.dataclass(frozen=True)
class Unit:
    name: str                 # the owning module's name, or "persistent"
    params: Tuple[int, ...]   # indices into ZeroPlan.params
    length: int               # padded length, a multiple of ALIGN * world
    shard: int                # length // world: what each rank owns
    partitioned: bool         # gathered before use (stage 3)


@dataclasses.dataclass(frozen=True)
class ZeroPlan:
    stage: int
    world: int
    params: Tuple[ParamPlacement, ...]
    units: Tuple[Unit, ...]

    @property
    def numel(self) -> int:
        """Elements of the whole flat layout, padding included."""
        return sum(u.length for u in self.units)

    def segments(self, rank: int) -> List[Tuple[int, int, int, int]]:
        """(param index, unit, start, end) of each parameter's elements
        within rank ``rank``'s shard of its unit."""
        out = []
        for i, p in enumerate(self.params):
            s = rank * self.units[p.unit].shard
            lo, hi = max(p.offset, s), min(p.offset + p.numel, s + self.units[p.unit].shard)
            if lo < hi:
                out.append((i, p.unit, lo - s, hi - s))
        return out


def plan_partition(params: Sequence[Tuple[str, Sequence[int], str]], stage: int, world: int,
                   persistence_threshold: int = 100_000) -> ZeroPlan:
    """The placement of ``params``, (name, shape, owning module's name)
    triples in the engine's order, at ZeRO ``stage`` over ``world`` ranks."""
    if not 0 <= stage <= 3:
        raise ValueError(f"ZeRO stage must be 0..3, got {stage}")
    if world < 1:
        raise ValueError(f"world size must be >= 1, got {world}")
    numels = []
    for _, shape, _ in params:
        n = 1
        for d in shape:
            n *= int(d)
        numels.append(n)
    persistent = [i for i, n in enumerate(numels) if stage == 3 and n < persistence_threshold]
    groups = [("persistent", persistent, False)] if persistent else []
    by_module = {}
    for i, (_, _, owner) in enumerate(params):
        if stage < 3 or numels[i] >= persistence_threshold:
            by_module.setdefault(owner, []).append(i)
    groups += [(owner, idx, stage == 3) for owner, idx in by_module.items()]

    placements: List[Optional[ParamPlacement]] = [None] * len(params)
    units = []
    for u, (name, idx, partitioned) in enumerate(groups):
        off = 0
        for i in idx:
            pname, shape, _ = params[i]
            placements[i] = ParamPlacement(
                name=pname, shape=tuple(int(d) for d in shape), numel=numels[i], unit=u,
                offset=off, partitioned=partitioned, master_partitioned=stage >= 1,
                grad_partitioned=stage >= 2)
            off = _round_up(off + numels[i], ALIGN)
        length = _round_up(max(off, 1), ALIGN * world)
        units.append(Unit(name=name, params=tuple(idx), length=length,
                          shard=length // world, partitioned=partitioned))
    return ZeroPlan(stage=stage, world=world, params=tuple(placements), units=tuple(units))


def partition_report(plan: ZeroPlan) -> str:
    """One line: how much of the model each kind of state partitions."""
    total = sum(p.numel for p in plan.params)
    sharded = sum(p.numel for p in plan.params if p.partitioned)
    what = {0: "nothing partitioned", 1: "fp32 masters and optimizer state partitioned",
            2: "fp32 masters, optimizer state and gradients partitioned",
            3: "fp32 masters, optimizer state, gradients and parameters partitioned"}
    msg = (f"ZeRO stage {plan.stage}: {total / 1e6:.1f}M params, {what[plan.stage]}; "
           f"{100.0 * sharded / max(1, total):.1f}% of the params partitioned over "
           f"{plan.world} rank(s) in {len(plan.units)} unit(s)")
    if plan.world == 1 and plan.stage > 0:
        msg += (" (a world of one: each partition is the whole, and the collectives "
                "still run)")
    return msg
