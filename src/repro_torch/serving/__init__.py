from repro_torch.serving.engine import GenerationResult, ServingEngine
from repro_torch.serving.switched import SERVING_KPMS, SwitchedDecodeConfig, SwitchedDecoder

__all__ = [
    "GenerationResult",
    "SERVING_KPMS",
    "ServingEngine",
    "SwitchedDecodeConfig",
    "SwitchedDecoder",
]
