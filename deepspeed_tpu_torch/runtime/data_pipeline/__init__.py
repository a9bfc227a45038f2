"""The curriculum data pipeline (reference ``deepspeed/runtime/data_pipeline``).

Counterpart of ``deepspeed_tpu/runtime/data_pipeline/``: the indexed dataset,
the curriculum scheduler, seqlen truncation, the offline data analyzer and
the metric curriculum sampler, all on the host in numpy; random-LTD's
scheduler and its gather and scatter (``data_routing``), on the device.
"""

from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import CurriculumScheduler
from deepspeed_tpu_torch.runtime.data_pipeline.data_routing import (RandomLTDScheduler,
                                                                    random_ltd_gather,
                                                                    random_ltd_scatter)
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling import apply_seqlen_curriculum

__all__ = ["CurriculumScheduler", "RandomLTDScheduler", "random_ltd_gather",
           "random_ltd_scatter", "apply_seqlen_curriculum"]
