"""mixtral-8x7b [moe] — 8 experts top-2, SWA. [arXiv:2401.04088; hf]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2.
"""
from repro_torch.configs.base import ArchConfig, ElasticSpec, Stage

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    stages=(Stage(("attn", "moe"), repeat=32),),
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32_000,
    head_dim=128,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    n_experts=8,
    top_k=2,
    moe_d_ff=14336,
    capacity_factor=1.25,
    subquadratic=True,                # SWA ⇒ bounded KV cache ⇒ long_500k runs
    elastic=ElasticSpec(
        depth_fracs=(0.5, 0.75, 1.0),
        ffn_fracs=(0.5, 0.75, 1.0),   # per-expert d_ff
        head_fracs=(0.5, 1.0),
        topk_options=(1, 2),          # MoE translation of WeightSlice
    ),
)
