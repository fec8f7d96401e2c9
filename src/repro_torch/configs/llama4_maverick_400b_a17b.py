"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + shared expert,
interleaved dense/MoE FFN layers, early fusion (text path modeled; the
fusion frontend is out of assigned scope).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
Each repeat unit = 2 transformer layers: (attn, moe, attn, mlp), so 24
units x 2 = 48 attention layers with FFNs alternating MoE/dense.
"""
from repro_torch.configs.base import ArchConfig, ElasticSpec, Stage

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    stages=(Stage(("attn", "moe", "attn", "mlp"), repeat=24),),
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    head_dim=128,
    rope_theta=500_000.0,
    n_experts=128,
    top_k=1,
    moe_d_ff=8192,
    shared_expert=True,
    capacity_factor=1.25,
    subquadratic=False,               # global-attn layers ⇒ long_500k skipped
    elastic=ElasticSpec(
        depth_fracs=(0.5, 0.75, 1.0),
        ffn_fracs=(0.5, 0.75, 1.0),
        head_fracs=(0.5, 1.0),
        topk_options=(1,),            # top-1 arch: k not elastic upward
    ),
)
