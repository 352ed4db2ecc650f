"""Runtime of the port: step factories, the fault-tolerant train loop,
coherence-gated multi-agent serving and tensor-parallel serving.

The package's names are imported from their modules at first use, so
that the model code can import :mod:`.tensor_parallel` (which imports no
model) without the step factories, which import the models."""

import importlib

#: each name the package exports, and the module that defines it
_FROM = {"CoherentAgent": "coherent_serving",
         "CoherentServingSystem": "coherent_serving",
         "ServingStats": "coherent_serving",
         "run_workload": "coherent_serving",
         "TrainLoopConfig": "train_loop", "TrainReport": "train_loop",
         "run_training": "train_loop"}

__all__ = ["steps", "tensor_parallel", *_FROM]


def __getattr__(name: str):
    if name in ("steps", "tensor_parallel"):
        return importlib.import_module(f"{__name__}.{name}")
    if name in _FROM:
        return getattr(importlib.import_module(f"{__name__}.{_FROM[name]}"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
