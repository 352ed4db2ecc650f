"""The optimizer of the port: AdamW with the JAX package's arithmetic
(``repro.optim``)."""

from repro_torch.optim.adamw import (AdamWConfig, AdamWState, init_state,
                                     apply_updates, lr_schedule,
                                     clip_by_global_norm, compress_grads,
                                     global_norm)

__all__ = ["AdamWConfig", "AdamWState", "init_state", "apply_updates",
           "lr_schedule", "clip_by_global_norm", "compress_grads",
           "global_norm"]
