"""Config schema for the model zoo.

One frozen dataclass tree describes every assigned architecture; the
model assembly (``repro.models``) is entirely config-driven, so adding an
architecture is a config file, not code.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    n_shared: int = 0             # always-on shared experts
    layer_stride: int = 1         # MoE every k-th layer (1 = all)
    layer_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    first_layer_dense: bool = False
    dense_d_ff: int = 0           # FFN dim for dense (non-MoE) layers
    # EP dispatch: >1 partitions tokens into per-data-shard dispatch
    # slices so the (E, C, d) buffer is built locally per shard instead
    # of being partial-summed across the whole data axis (the
    # dispatch-buffer all-reduce is the dominant MoE collective
    # otherwise).  Set to the mesh's DP degree by the launcher.
    dispatch_slices: int = 1
    dispatch_axes: tuple = ()     # mesh axes the slice dim maps onto


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0          # 0 = full-rank q projection (V2-lite)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model/16)
    chunk: int = 128              # scan checkpointing chunk


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64          # low-rank dim of data-dependent decay
    mix_lora: int = 32            # low-rank dim of ddlerp token-shift
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class VisionStubConfig:
    """Modality frontend is a STUB per the assignment: input_specs()
    provides precomputed, already-projected patch embeddings."""
    n_image_tokens: int = 1024
    n_images: int = 1


@dataclasses.dataclass(frozen=True)
class AudioStubConfig:
    """Whisper conv frontend stub: precomputed frame embeddings."""
    frame_ratio: int = 1          # encoder frames per "seq_len" unit
    dec_ratio: int = 4            # decoder tokens = seq_len // dec_ratio


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    hidden_act: str = "silu"      # silu -> SwiGLU, gelu -> GeGLU
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    use_qk_norm: bool = False
    use_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    embed_scale: bool = False     # gemma: embeddings * sqrt(d_model)
    max_seq_len: int = 8192
    dtype: str = "bfloat16"

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    vision: Optional[VisionStubConfig] = None
    audio: Optional[AudioStubConfig] = None

    # hybrid (jamba): one attention layer per `attn_period`, rest mamba
    attn_period: int = 0
    attn_offset: int = 0
    # vlm: cross-attention layer every `cross_attn_period` (llama-vision)
    cross_attn_period: int = 0
    cross_attn_offset: int = 3
    # enc-dec (whisper)
    encoder_layers: int = 0

    sub_quadratic: bool = False   # eligible for long_500k
    # SSPerf knob: pin the residual stream's batch dim to these mesh
    # axes at superblock boundaries (empty = let XLA choose layouts)
    residual_axes: tuple = ()

    def kv_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kind(self, i: int) -> str:
        """'attn' | 'mamba' for mixer at layer i."""
        if self.attn_period:
            return ("attn" if i % self.attn_period == self.attn_offset
                    else "mamba")
        if self.rwkv is not None:
            return "rwkv"
        return "attn"

    def is_cross_layer(self, i: int) -> bool:
        return (self.cross_attn_period > 0
                and i % self.cross_attn_period == self.cross_attn_offset)

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        if self.moe.first_layer_dense and i == 0:
            return False
        return (i % self.moe.layer_stride) == self.moe.layer_offset


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
