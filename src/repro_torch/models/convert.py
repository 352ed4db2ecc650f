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
from repro_torch.models.common import DTYPES, dtype_of


def params_from_numpy(tree, cfg: ModelConfig, device=None) -> dict:
    """A nested dict of numpy arrays as the port's params on ``device``
    (``None``: CUDA).  Each leaf keeps its own float type, as the JAX
    tree does: ``cfg.dtype`` for most, fp32 for the leaves a model keeps
    in fp32 inside a bf16 model (rwkv6's decay, bonus and mixing
    coefficients, the cross-attention's 0-d ``gate``, stacked to one
    a layer, mamba's ``dt_bias``, ``a_log`` and ``d_skip``);
    ``ml_dtypes.bfloat16`` becomes ``torch.bfloat16``.
    A leaf of another type than those two raises ``TypeError``."""
    dev = resolve_device(device)
    allowed = {torch.float32, dtype_of(cfg.dtype)}

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        arr = np.asarray(x)
        dtype = DTYPES.get(arr.dtype.name)
        if dtype not in allowed:
            raise TypeError(f"a {arr.dtype.name} leaf in a {cfg.dtype} "
                            f"model")
        return torch.from_numpy(arr.astype(np.float32)).to(device=dev,
                                                          dtype=dtype)

    return leaf(tree)
