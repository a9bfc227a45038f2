from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig  # noqa: F401
from deepspeed_tpu_torch.inference.engine import InferenceEngine  # noqa: F401
