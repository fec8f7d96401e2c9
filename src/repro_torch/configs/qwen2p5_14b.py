"""qwen2.5-14b [dense] — GQA, QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""
from repro_torch.configs.base import ArchConfig, ElasticSpec, Stage

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    stages=(Stage(("attn", "mlp"), repeat=48),),
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152_064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    subquadratic=False,               # full attention ⇒ long_500k skipped
    elastic=ElasticSpec(
        depth_fracs=(0.5, 0.75, 1.0),
        ffn_fracs=(0.5, 0.75, 1.0),
        head_fracs=(0.5, 1.0),
    ),
)
