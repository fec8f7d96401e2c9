"""stablelm-3b [dense] — MHA (kv=32), partial rotary (25%), LayerNorm.
[hf:stabilityai/stablelm-2-1_6b; unverified]

32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.
"""
from repro_torch.configs.base import ArchConfig, ElasticSpec, Stage

CONFIG = ArchConfig(
    name="stablelm-3b",
    family="dense",
    stages=(Stage(("attn", "mlp"), repeat=32),),
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50_304,
    head_dim=80,                      # 2560 / 32
    rotary_pct=0.25,
    rope_theta=10_000.0,
    norm="layernorm",
    subquadratic=False,               # full attention ⇒ long_500k skipped
    elastic=ElasticSpec(
        depth_fracs=(0.5, 0.75, 1.0),
        ffn_fracs=(0.5, 0.75, 1.0),
        head_fracs=(0.5, 1.0),        # MHA: any head subset (group size 1)
    ),
)
