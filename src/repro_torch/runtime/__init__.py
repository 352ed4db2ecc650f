"""Runtime of the port: step factories, the fault-tolerant train loop and
coherence-gated multi-agent serving."""

from repro_torch.runtime import steps
from repro_torch.runtime.coherent_serving import (CoherentAgent,
                                                  CoherentServingSystem,
                                                  ServingStats,
                                                  run_workload)
from repro_torch.runtime.train_loop import (TrainLoopConfig, TrainReport,
                                            run_training)

__all__ = ["steps", "TrainLoopConfig", "TrainReport", "run_training",
           "CoherentAgent", "CoherentServingSystem", "ServingStats",
           "run_workload"]
