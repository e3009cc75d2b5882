"""Architecture configuration system.

One frozen dataclass describes every assigned architecture; family-specific
sub-configs are optional fields. `reduced()` produces the CPU-smoke-test
variant of the same family (small widths/layers/vocab, same block pattern).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int  # routed experts
    top_k: int
    n_shared: int = 0  # shared (always-on) experts
    d_expert: int = 0  # per-expert FFN hidden size
    moe_layer_step: int = 1  # MoE every k-th layer (1 = all layers)
    first_dense_layers: int = 0  # leading dense layers (deepseek style)
    dense_d_ff: int = 0  # FFN size for non-MoE layers


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style SSD mixer (zamba2 hybrid)."""

    state_dim: int = 64
    expand: int = 2  # d_inner = expand * d_model
    conv_width: int = 4
    head_dim: int = 64  # SSD head dim; n_ssm_heads = d_inner // head_dim
    chunk: int = 128  # chunked-scan block length
    # Hybrid pattern: a shared attention+MLP block is applied after every
    # `shared_attn_every` SSM layers (Zamba2's shared transformer block).
    shared_attn_every: int = 6


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block stack: mostly mLSTM with periodic sLSTM."""

    slstm_every: int = 8  # every k-th block is sLSTM, rest mLSTM
    proj_factor: float = 2.0  # up-projection inside blocks
    conv_width: int = 4
    chunk: int = 128  # mLSTM chunkwise-parallel length


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 32
    max_source_positions: int = 0  # 0 = same as seq len


@dataclasses.dataclass(frozen=True)
class CrossAttnConfig:
    """VLM: cross-attention image layers every k-th layer (llama3.2-vision)."""

    every: int = 5
    n_image_tokens: int = 1024


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | hybrid | ssm | moe | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    act: str = "silu"  # silu (SwiGLU) | gelu (plain MLP, whisper)
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encdec: Optional[EncDecConfig] = None
    cross_attn: Optional[CrossAttnConfig] = None
    # Which shape cells apply (see DESIGN.md §Arch-applicability):
    supports_long_context: bool = False  # sub-quadratic mixer -> long_500k
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self) -> "ArchConfig":
        """Same family/pattern, tiny dimensions — for CPU smoke tests."""
        changes = dict(
            n_layers=min(self.n_layers, 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // self.n_heads)),
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16,
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe,
                n_experts=8,
                top_k=min(self.moe.top_k, 2),
                d_expert=32,
                dense_d_ff=64 if self.moe.dense_d_ff else 0,
            )
        if self.mla:
            changes["mla"] = MLAConfig(
                kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                v_head_dim=16,
            )
        if self.ssm:
            changes["ssm"] = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=16, chunk=16,
                shared_attn_every=2,
            )
            changes["n_layers"] = 5  # exercises pattern + trailing layers
        if self.xlstm:
            changes["xlstm"] = dataclasses.replace(
                self.xlstm, slstm_every=2, chunk=16
            )
            changes["n_layers"] = 4
        if self.encdec:
            changes["encdec"] = EncDecConfig(n_encoder_layers=2)
        if self.cross_attn:
            changes["cross_attn"] = CrossAttnConfig(every=2, n_image_tokens=16)
        changes["dtype"] = "float32"
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def reduced(self) -> "ShapeCell":
        return ShapeCell(self.name, seq_len=32, global_batch=2, kind=self.kind)


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def applicable_shapes(cfg: ArchConfig) -> Tuple[ShapeCell, ...]:
    """Shape cells that run for this arch (skips recorded in the roofline
    table): long_500k only for sub-quadratic mixers."""
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and not cfg.supports_long_context:
            continue
        out.append(s)
    return tuple(out)
