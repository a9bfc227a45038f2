"""Elastic training: batch-size math that stays valid as ranks come and go,
and the agent that supervises a run through failures and preemption.

Counterpart of ``deepspeed_tpu/elasticity/`` (``config.py``,
``elasticity.py``, ``elastic_agent.py``). Its ``resize.py`` (serving a
world change from the snapshot ladder) needs several devices: a later
slice of the port.
"""

from deepspeed_tpu_torch.elasticity.config import ElasticityConfig, ElasticityError  # noqa: F401
from deepspeed_tpu_torch.elasticity.elastic_agent import (  # noqa: F401
    DSElasticAgent, PreemptionSignal)
from deepspeed_tpu_torch.elasticity.elasticity import (  # noqa: F401
    compute_elastic_config, elasticity_enabled, get_candidate_batch_sizes,
    get_compatible_chip_counts, validate_elastic_config_from_script_args)
