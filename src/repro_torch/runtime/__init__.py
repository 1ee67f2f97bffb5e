from repro_torch.runtime.trainer import Trainer, StragglerMonitor, TrainerConfig  # noqa: F401
from repro_torch.runtime.serving import ServingEngine, EngineConfig  # noqa: F401
