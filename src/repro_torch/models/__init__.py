"""Config-driven model zoo in PyTorch (the dense family, the MoE
feed-forward, MLA, RWKV6, Mamba's hybrid and the context families),
with the JAX package's names and parameter trees."""

from repro_torch.models.transformer import (init_params, forward_train,
                                            prefill, decode_step,
                                            init_cache, layer_specs,
                                            split_pattern)
from repro_torch.models.common import params_count, params_bytes
from repro_torch.models.convert import params_from_numpy

__all__ = ["init_params", "forward_train", "prefill", "decode_step",
           "init_cache", "layer_specs", "split_pattern", "params_count",
           "params_bytes", "params_from_numpy"]
