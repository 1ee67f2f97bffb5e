from repro_torch.runtime.serving import EngineConfig, ServingEngine  # noqa: F401
