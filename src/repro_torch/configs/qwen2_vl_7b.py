"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064. The vision
frontend is a stub per the assignment: ``input_specs()`` provides
precomputed patch embeddings (frontend='embed') for train/prefill.
"""
from repro_torch.configs.base import ArchConfig, ElasticSpec, Stage

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    stages=(Stage(("attn", "mlp"), repeat=28),),
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152_064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),      # temporal/h/w over head_dim/2 = 64 slots
    frontend="embed",
    subquadratic=False,               # full attention ⇒ long_500k skipped
    elastic=ElasticSpec(
        depth_fracs=(0.5, 0.75, 1.0),
        ffn_fracs=(0.5, 0.75, 1.0),
        head_fracs=(0.5, 1.0),        # whole GQA groups (28H/4kv ⇒ 7-head groups)
    ),
)
