"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (the route for CPU tensors, and the reference the kernel is
held to):

  * ``mesi_tick``  - batched MESI coherence tick (fleet-scale DES)
  * ``chunk_tick`` - batched chunk-diff / delta-coherence tick (content
                     plane; consumes mesi_tick's per-agent miss output)
  * ``rmsnorm``, ``flash_attention``, ``decode_attention``,
    ``rwkv6_scan``, ``causal_conv1d``, ``selective_scan`` (and its
    gated mode ``selective_scan_gated``)
                   - the model kernels of the serving path, public
                     through ``kernels.ops`` (the first four with the JAX
                     package's signatures); the backward kernels of
                     rmsnorm, flash attention, the WKV scan, the causal
                     conv and the selective scan beside their forwards
                     (``rmsnorm_bwd``, ``flash_attention_bwd``,
                     ``rwkv6_scan_bwd``, ``causal_conv1d_bwd``,
                     ``selective_scan_bwd``)

Sources live in ``csrc/``; ``build`` compiles them with nvcc at first
use.
"""

from repro_torch.kernels.backend import resolve_device, use_kernel
from repro_torch.kernels.chunk_diff import (N_CHUNK_COUNTERS, chunk_tick,
                                            chunk_tick_, chunk_tick_plain_,
                                            resolve_chunk_route)
from repro_torch.kernels.mesi_transition import (N_COUNTERS,
                                                 mesi_decision_batch,
                                                 mesi_tick, mesi_tick_,
                                                 mesi_tick_plain_)
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_plain

__all__ = ["N_CHUNK_COUNTERS", "N_COUNTERS", "chunk_tick", "chunk_tick_",
           "chunk_tick_plain_", "mesi_decision_batch", "mesi_tick",
           "mesi_tick_", "mesi_tick_plain_", "resolve_chunk_route",
           "resolve_device", "rwkv6_scan", "rwkv6_scan_plain", "use_kernel"]
