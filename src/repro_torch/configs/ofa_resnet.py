"""ofa_resnet — the paper's own serving architecture: an OFA-ResNet50
SuperNet [Cai et al., ICLR'20] with SubNetAct operators, including true
BatchNorm SubnetNorm (per-subnet mu/sigma tables).

Pareto subnets span 0.9-7.5 GFLOPs / 73-80% top-1 (paper §6.1); our
accuracy *predictor* in core/pareto.py is fit to exactly that range.
This arch is the paper-reproduction vehicle (benchmarks/), additional
to the 10 assigned LM archs.
"""
from repro_torch.configs.base import ArchConfig, ElasticSpec, Stage

CONFIG = ArchConfig(
    name="ofa_resnet",
    family="conv",
    # 4 stages x max 4 residual conv units each (OFA-ResNet depth space
    # D in {2,3,4} per stage).
    stages=(
        Stage(("conv",), repeat=4),
        Stage(("conv",), repeat=4),
        Stage(("conv",), repeat=4),
        Stage(("conv",), repeat=4),
    ),
    d_model=2048,                     # final feature width
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=0,
    conv_stage_widths=(256, 512, 1024, 2048),
    img_size=224,
    n_classes=1000,
    norm="layernorm",                 # (unused; conv path uses BatchNorm tables)
    dtype="float32",
    elastic=ElasticSpec(
        depth_fracs=(0.5, 0.75, 1.0),     # D: 2/3/4 units per stage
        ffn_fracs=(0.45, 0.7, 1.0),       # E: expand-ratio space
        head_fracs=(0.65, 0.8, 1.0),      # W: width-multiplier space
    ),
    notes="Paper's own arch. True BatchNorm SubnetNorm with calibrated "
          "per-subnet (mu, sigma) tables — see models/convnet.py + "
          "core/calibrate.py.",
)
