"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (3:1 interleave).
[arXiv:2405.04517; unverified]

12L d_model=768 4H d_ff=0 vocab=50304. d_ff=0: xLSTM mLSTM blocks have
no separate FFN (up-projection is internal); sLSTM blocks carry a small
post-FFN (proj factor 4/3) per the paper.
"""
from repro_torch.configs.base import ArchConfig, ElasticSpec, Stage

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    stages=(Stage(("mlstm", "mlstm", "mlstm", "slstm"), repeat=3),),
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    head_dim=192,                     # 768 / 4
    mlstm_proj_factor=2.0,
    slstm_proj_factor=4.0 / 3.0,
    tie_embeddings=True,
    subquadratic=True,                # recurrent ⇒ long_500k runs
    elastic=ElasticSpec(
        depth_fracs=(1.0 / 3.0, 2.0 / 3.0, 1.0),
        ffn_fracs=(0.5, 1.0),         # sLSTM post-FFN width only
        head_fracs=(1.0,),            # recurrent state dims not elastic
    ),
    notes="Recurrent state dims (mLSTM C/n, sLSTM c/n/h/m) are NOT "
          "width-elastic; only depth + sLSTM FFN width are.",
)
