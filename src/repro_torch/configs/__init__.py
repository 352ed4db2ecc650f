"""Architecture configs: the schema and the registry of the assigned
architectures, as in the JAX package."""

from repro_torch.configs.base import (ModelConfig, MoEConfig, MLAConfig,
                                      MambaConfig, RWKVConfig, ShapeConfig,
                                      SHAPES, VisionStubConfig,
                                      AudioStubConfig)
from repro_torch.configs.registry import (ARCHS, get, register,
                                          smoke_config, n_params_analytic,
                                          n_active_params)

__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "MambaConfig", "RWKVConfig",
    "ShapeConfig", "SHAPES", "VisionStubConfig", "AudioStubConfig",
    "ARCHS", "get", "register", "smoke_config", "n_params_analytic",
    "n_active_params",
]
