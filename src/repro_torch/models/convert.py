"""Parameters of the JAX package's models carried into the port.

The port keeps the JAX package's parameter tree (the same nested key
names, dense weights as (d_in, d_out), superblocks stacked on a leading
axis), so a tree of numpy arrays - ``jax.tree.map(np.asarray, params)``
on the JAX side - converts leaf by leaf.  Only the KV cache's layout
differs, and caches are not parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.common import dtype_of


def params_from_numpy(tree, cfg: ModelConfig, device=None) -> dict:
    """A nested dict of numpy arrays (any float type, bfloat16 from
    ``ml_dtypes`` included) as the port's params: tensors of
    ``cfg.dtype`` on ``device`` (``None``: CUDA)."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        arr = np.array(x, dtype=np.float32)
        return torch.from_numpy(arr).to(device=dev, dtype=dtype)

    return leaf(tree)
