"""The ``elasticity`` ds_config block.

Counterpart of ``deepspeed_tpu/elasticity/config.py`` (and of the block the
JAX ``runtime/config.py`` reads): the reference's v0.1/v0.2 keys with their
bounds and checks, and the ``resize`` sub-block. A dataclass on the port's
``DeepSpeedConfigModel`` (no pydantic on the card's machine); unknown keys
are rejected with a did-you-mean hint. ``resize.enabled`` (serving a world
change from the RAM and emergency tiers) needs several devices and raises.
"""

from __future__ import annotations

import dataclasses

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class ElasticityError(Exception):
    """Raised on inconsistent elastic configuration."""


LATEST_ELASTICITY_VERSION = 0.2
MINIMUM_DEEPSPEED_VERSION = "0.1.0"
RESIZE_TIERS = ("ram", "emergency", "disk")


def _at_least(block, **bounds) -> None:
    for name, lo in bounds.items():
        if getattr(block, name) < lo:
            raise ValueError(f"{type(block).__name__}.{name} must be >= {lo}, "
                             f"got {getattr(block, name)}")


@dataclasses.dataclass
class ElasticityResizeConfig(DeepSpeedConfigModel):
    """Serving a world change at restore time from the snapshot ladder. The
    port refuses ``enabled``: a snapshot on another world degrades loudly to
    the verified disk tier, which is JAX's behaviour without the knob."""
    enabled: bool = False
    min_world_size: int = 1
    tiers: list = dataclasses.field(default_factory=lambda: list(RESIZE_TIERS))

    def __post_init__(self):
        _at_least(self, min_world_size=1)
        bad = [t for t in self.tiers if t not in RESIZE_TIERS]
        if bad:
            raise ValueError(f"elasticity.resize.tiers: unknown tier(s) {bad}; "
                             f"known: {RESIZE_TIERS}")
        if not self.tiers:
            raise ValueError("elasticity.resize.tiers must name at least one tier (else no "
                             "resize could ever be served)")
        if self.enabled:
            raise NotImplementedError(
                "ds_config elasticity.resize.enabled=true (resharding the RAM and emergency "
                "tiers onto another world) needs several devices, a later slice of the port")


@dataclasses.dataclass
class ElasticityConfig(DeepSpeedConfigModel):
    """The ``elasticity`` block of ds_config."""
    enabled: bool = False
    max_train_batch_size: int = 2000
    micro_batch_sizes: list = dataclasses.field(default_factory=lambda: [2, 4, 6])
    min_gpus: int = 1
    max_gpus: int = 10000
    min_time: int = 0
    version: float = 0.2
    prefer_larger_batch: bool = dataclasses.field(
        default=True, metadata={"alias": "prefer_larger_batch_size"})
    ignore_non_elastic_batch_info: bool = False
    # v0.2: world sizes must be multiples of (GPUs per node x mp)
    model_parallel_size: int = 1
    num_gpus_per_node: int = 1
    resize: ElasticityResizeConfig = dataclasses.field(default_factory=ElasticityResizeConfig)

    def __post_init__(self):
        _at_least(self, max_train_batch_size=1, min_gpus=1, max_gpus=1, min_time=0,
                  model_parallel_size=1, num_gpus_per_node=1)
        if self.min_gpus > self.max_gpus:
            raise ElasticityError(f"min_gpus ({self.min_gpus}) > max_gpus ({self.max_gpus})")
        if any(m <= 0 for m in self.micro_batch_sizes):
            raise ElasticityError(f"micro_batch_sizes must be positive: {self.micro_batch_sizes}")
        if self.version not in (0.1, 0.2):
            raise ElasticityError(f"unsupported elasticity version {self.version}")
