"""The port's MoE configurations, mixtral-8x7b and
llama4-maverick-400b-a17b, against ``repro`` (split from
``test_torch_configs``, whose twins and test bodies it takes, so that the
files run on separate workers; llama4's twin runs in
``test_torch_configs_llama4``):

* the port's copies of the configs equal ``repro.configs`` field by
  field, and their shapes reach the kernels;
* mixtral's ``reduced()`` with experts of d_ff 512 (so that switch mode
  has three widths), top-2 with elastic k and a window of 8, runs
  forward, prefill and decode steps against ``repro.models.lm`` for
  every subnet, in both WeightSlice modes (fp32, 2e-3), and
  ``lm.from_jax_params`` converts its tree.
"""
import pytest

from repro_torch.configs import get_config as tget_config
from repro_torch.core import subnet as tsn
from test_torch_configs import (  # noqa: F401 - collected here too
    MOE_NAMES, _build, check_config_equals_jax, one_thread,
    test_decode_steps_match_jax_for_every_subnet,
    test_forward_and_prefill_match_jax_for_every_subnet,
    test_from_jax_params_converts_each_tree)


@pytest.fixture(scope="module", params=["mixtral-moe512"])
def model(request):
    return _build(request.param)


@pytest.fixture(scope="module", params=["mixtral-moe512"])
def twin(request):
    return _build(request.param)


@pytest.mark.parametrize("name", MOE_NAMES)
def test_port_config_equals_jax_config(name):
    check_config_equals_jax(name)


def test_moe_config_shapes_reach_the_kernels():
    """The MoE configs' attention at head_dim 128 with G = 4 (mixtral, a
    4096 window) and G = 5 (llama4); wo segments of 512 and 640; the
    expert widths of switch mode multiples of 8, one per ``ffn_bucket``;
    elastic k of 1 and 2 (mixtral) and 1 (llama4)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as tattn
    want = {"mixtral-8x7b": (4, 4096, 512, (1, 2), 14336),
            "llama4-maverick-400b-a17b": (5, 0, 640, (1,), 8192)}
    for name, (G, window, seg, ks, f) in want.items():
        cfg = tget_config(name)
        assert cfg.family == "moe" and cfg.resolved_head_dim == 128
        assert 128 in fa.HEAD_DIMS and 128 in da.HEAD_DIMS
        assert tsn.head_group_size(cfg) == G and cfg.sliding_window == window
        assert cfg.n_heads * 128 // tattn.wo_segments(cfg) == seg
        assert cfg.resolved_moe_d_ff == f
        opts = tsn.width_options(cfg)["moe_ffn"]
        assert opts == [f // 2, 3 * f // 4, f]
        got_k = set()
        for sub in tsn.enumerate_space(cfg):
            ctrl = tsn.make_control(cfg, sub)
            assert int(ctrl["moe_ffn_width"]) == opts[int(ctrl["ffn_bucket"])]
            got_k.add(int(ctrl["topk"]))
        assert got_k == set(ks)
