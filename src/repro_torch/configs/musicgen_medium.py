"""musicgen-medium [audio] — decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048. GELU FFN,
sinusoidal positions, LayerNorm. The EnCodec frontend is a stub per the
assignment: ``input_specs()`` provides precomputed frame embeddings for
train/prefill; decode consumes codebook token ids (vocab 2048).
"""
from repro_torch.configs.base import ArchConfig, ElasticSpec, Stage

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    stages=(Stage(("attn", "mlp"), repeat=48),),
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,                      # 1536 / 24
    norm="layernorm",
    ffn_act="gelu",
    pos_embed="sinusoidal",
    frontend="embed",
    subquadratic=False,               # full attention ⇒ long_500k skipped
    elastic=ElasticSpec(
        depth_fracs=(0.5, 0.75, 1.0),
        ffn_fracs=(0.5, 0.75, 1.0),
        head_fracs=(0.5, 1.0),
    ),
)
