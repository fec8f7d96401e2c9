"""Architecture + shape configuration system.

Every assigned architecture is expressed as an :class:`ArchConfig` made of
repeated *stages* (scan-over-layers friendly), an :class:`ElasticSpec`
describing the SubNetAct control space, and a set of named input shapes.

The FULL configs are only ever lowered with ShapeDtypeStructs (dry-run);
smoke tests instantiate ``reduced()`` variants.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

# --------------------------------------------------------------------------
# Elasticity (SubNetAct control space)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ElasticSpec:
    """Discrete SubNetAct control space for one architecture.

    ``depth_fracs``  - fraction of repeated units executed (LayerSelect).
    ``ffn_fracs``    - fraction of d_ff channels active (WeightSlice).
    ``head_fracs``   - fraction of *query* head groups active (WeightSlice).
                       KV heads stay fixed (stable cache layout).
    ``topk_options`` - MoE top-k choices (MoE translation of width).
    """

    depth_fracs: Tuple[float, ...] = (1.0,)
    ffn_fracs: Tuple[float, ...] = (1.0,)
    head_fracs: Tuple[float, ...] = (1.0,)
    topk_options: Tuple[int, ...] = ()

    @property
    def num_subnets(self) -> int:
        n = len(self.depth_fracs) * len(self.ffn_fracs) * len(self.head_fracs)
        if self.topk_options:
            n *= len(self.topk_options)
        return n


# --------------------------------------------------------------------------
# Stages (block pattern engine)
# --------------------------------------------------------------------------

# Block kinds understood by models/backbone.py ("conv" is handled by
# models/convnet.py — the paper's own OFA-ResNet supernet, not an LM).
BLOCK_KINDS = (
    "attn",       # self attention (GQA/MHA, RoPE/M-RoPE, optional SWA)
    "mlp",        # dense SwiGLU/GELU FFN (elastic width)
    "moe",        # top-k routed experts (+ optional shared expert)
    "mamba",      # Mamba2 SSD block
    "mlstm",      # xLSTM matrix-memory block
    "slstm",      # xLSTM scalar-memory block
    "conv",       # residual conv block (OFA-ResNet; models/convnet.py)
)


@dataclass(frozen=True)
class Stage:
    """``repeat`` copies of a unit made of ``pattern`` sub-blocks.

    Parameters for each sub-block slot are stacked along a leading
    ``repeat`` axis so the backbone can ``lax.scan`` over them: compile
    time is O(1) in depth.
    """

    pattern: Tuple[str, ...]
    repeat: int

    def __post_init__(self):
        for kind in self.pattern:
            if kind not in BLOCK_KINDS:
                raise ValueError(f"unknown block kind {kind!r}")

    @property
    def layers_per_unit(self) -> int:
        # A "layer" = one attention-ish or mixer-ish sub-block.
        return len(self.pattern)


# --------------------------------------------------------------------------
# Architecture config
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio|conv
    stages: Tuple[Stage, ...]
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- attention extras ---
    qkv_bias: bool = False
    sliding_window: int = 0          # 0 = full attention
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0          # stablelm uses partial rotary
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # 0 -> d_ff
    shared_expert: bool = False
    capacity_factor: float = 1.25

    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- zamba2-style shared attention ---
    shared_attn_period: int = 0      # every k-th mamba unit also runs the
                                     # (weight-shared) attention block

    # --- xLSTM ---
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0

    # --- norm ---
    norm: str = "rmsnorm"            # rmsnorm|layernorm
    norm_eps: float = 1e-5

    # --- FFN / positions (musicgen uses GELU + sinusoidal) ---
    ffn_act: str = "swiglu"          # swiglu|gelu
    pos_embed: str = "rope"          # rope|sinusoidal

    # --- IO / modality ---
    frontend: str = "token"          # token | embed (precomputed embeddings)
    tie_embeddings: bool = False

    # --- SubNetAct ---
    elastic: ElasticSpec = field(default_factory=ElasticSpec)

    # --- sub-quadratic? (controls long_500k applicability) ---
    subquadratic: bool = False

    # --- conv supernet (paper's own OFA-ResNet arch) ---
    conv_stage_widths: Tuple[int, ...] = ()   # base channels per stage
    img_size: int = 224
    n_classes: int = 0

    # --- misc ---
    dtype: str = "bfloat16"
    notes: str = ""

    # ---------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_layers(self) -> int:
        return sum(s.repeat * s.layers_per_unit for s in self.stages)

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        stages = tuple(
            Stage(s.pattern, repeat=max(1, min(2, s.repeat))) for s in self.stages
        )
        small = dict(
            stages=stages,
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // max(self.n_heads, 1))),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            dtype="float32",
        )
        if self.n_experts:
            small.update(n_experts=4, top_k=min(self.top_k, 2) or 1, moe_d_ff=128)
        if self.ssm_state:
            small.update(ssm_state=16, ssm_chunk=32, ssm_head_dim=16)
        if self.shared_attn_period:
            small.update(shared_attn_period=2)
        if self.sliding_window:
            small.update(sliding_window=64)
        if self.mrope_sections:
            small.update(mrope_sections=(8, 4, 4))
        return self.replace(**small)


# --------------------------------------------------------------------------
# Input shapes (assigned per the task: 4 shapes x 10 archs = 40 cells)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether a dry-run cell applies (long_500k needs sub-quadratic attn)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "skip: pure full-attention arch; 512k dense decode excluded by shape spec"
    return True, ""
