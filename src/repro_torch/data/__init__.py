"""The port's data stream (a copy of ``repro.data``, numpy only)."""

from repro_torch.data.pipeline import (DataConfig, SyntheticLMStream,
                                       PrefetchLoader)

__all__ = ["DataConfig", "SyntheticLMStream", "PrefetchLoader"]
