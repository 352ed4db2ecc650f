"""Architecture configs (the schema and the registry of the assigned
architectures) and the layered coherence-config surface (core ->
service -> shard topology), as in the JAX package."""

from repro_torch.configs.base import (ModelConfig, MoEConfig, MLAConfig,
                                      MambaConfig, RWKVConfig, ShapeConfig,
                                      SHAPES, VisionStubConfig,
                                      AudioStubConfig)
from repro_torch.configs.registry import (ARCHS, get, register,
                                          smoke_config, n_params_analytic,
                                          n_active_params)
from repro_torch.configs.coherence import (CoherenceConfig, CoherenceCore,
                                           ServiceLayer, ShardTopology,
                                           shard_of_artifact)

__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "MambaConfig", "RWKVConfig",
    "ShapeConfig", "SHAPES", "VisionStubConfig", "AudioStubConfig",
    "ARCHS", "get", "register", "smoke_config", "n_params_analytic",
    "n_active_params",
    "CoherenceConfig", "CoherenceCore", "ServiceLayer", "ShardTopology",
    "shard_of_artifact",
]
