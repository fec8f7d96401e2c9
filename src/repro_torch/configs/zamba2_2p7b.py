"""zamba2-2.7b [hybrid] — Mamba2 backbone + weight-shared attention
block applied periodically (the arch's own weight-sharing synergizes
with SubNetAct's). [arXiv:2411.15242; hf]

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000 ssm_state=64.
"""
from repro_torch.configs.base import ArchConfig, ElasticSpec, Stage

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    stages=(Stage(("mamba",), repeat=54),),
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32_000,
    head_dim=80,                      # 2560 / 32
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    shared_attn_period=6,             # shared attn+MLP block every 6 mamba units
    tie_embeddings=True,
    subquadratic=True,                # SSM state ⇒ long_500k eligible
    elastic=ElasticSpec(
        depth_fracs=(0.5, 0.75, 1.0),
        ffn_fracs=(0.5, 0.75, 1.0),   # shared-block MLP width; SSM dims fixed
        head_fracs=(0.5, 1.0),        # shared-block q heads
    ),
    notes="Mamba2 + zamba2-style shared transformer block. SSM state dims "
          "are not width-elastic (recurrence integrity).",
)
