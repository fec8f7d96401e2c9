"""qwen2-1.5b [dense] — GQA, QKV bias, tied embeddings.
[arXiv:2407.10671; hf]

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, ElasticSpec, Stage

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    stages=(Stage(("attn", "mlp"), repeat=28),),
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    subquadratic=False,               # full attention ⇒ long_500k skipped
    elastic=ElasticSpec(
        depth_fracs=(0.5, 0.75, 1.0),
        ffn_fracs=(0.5, 0.75, 1.0),
        head_fracs=(0.5, 1.0),        # 12H/2kv ⇒ 6-head groups
    ),
)
