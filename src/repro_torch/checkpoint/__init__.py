"""The port's checkpoints, in the JAX package's on-disk layout."""

from repro_torch.checkpoint.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
