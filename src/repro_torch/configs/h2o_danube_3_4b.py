"""h2o-danube-3-4b [dense] — llama+mistral mix, SWA.
[arXiv:2401.16818; unverified]

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.
"""
from repro_torch.configs.base import ArchConfig, ElasticSpec, Stage

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    stages=(Stage(("attn", "mlp"), repeat=24),),
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32_000,
    head_dim=120,                     # 3840 / 32
    sliding_window=4096,
    rope_theta=10_000.0,
    subquadratic=True,                # SWA ⇒ bounded KV cache ⇒ long_500k runs
    elastic=ElasticSpec(
        depth_fracs=(0.5, 0.75, 1.0),
        ffn_fracs=(0.5, 0.75, 1.0),
        head_fracs=(0.5, 1.0),
    ),
)
