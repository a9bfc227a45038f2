"""The curriculum data pipeline (reference ``deepspeed/runtime/data_pipeline``).

Counterpart of ``deepspeed_tpu/runtime/data_pipeline/``: the indexed dataset,
the curriculum scheduler, seqlen truncation, the offline data analyzer and
the metric curriculum sampler, all on the host in numpy. Random-LTD
(``data_routing``) is a later slice of the port.
"""

from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import CurriculumScheduler
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling import apply_seqlen_curriculum

__all__ = ["CurriculumScheduler", "apply_seqlen_curriculum"]
