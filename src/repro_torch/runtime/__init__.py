"""Runtime of the port: coherence-gated multi-agent serving."""

from repro_torch.runtime.coherent_serving import (CoherentAgent,
                                                  CoherentServingSystem,
                                                  ServingStats,
                                                  run_workload)

__all__ = ["CoherentAgent", "CoherentServingSystem", "ServingStats",
           "run_workload"]
