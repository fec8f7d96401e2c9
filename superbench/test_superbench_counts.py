"""The counts of operations and bytes on shapes worked by hand."""
import pytest

from superbench import subnet
from superbench.counts import flash_attention, lm_step, sliced_matmul


def test_sliced_matmul_dense():
    # 4 rows, 3 of 5 input channels, 2 of 6 output channels live
    assert sliced_matmul.dense(4, 3, 2, 6) == (2 * 4 * 3 * 2,
                                               2 * (4 * 3 + 3 * 2 + 4 * 6))


def test_sliced_matmul_experts():
    # 2 experts, 10 rows routed, 8 slots an expert, 16 -> 4 of 32 outputs
    flops, nbytes = sliced_matmul.experts(2, 10, 8, 16, 4, 32)
    assert flops == 2 * 10 * 16 * 4
    assert nbytes == 2 * (10 * 16 + 2 * 16 * 4 + 2 * 8 * 32)


def test_causal_pairs():
    assert flash_attention.causal_pairs(4) == 1 + 2 + 3 + 4
    assert flash_attention.causal_pairs(4, window=2) == 1 + 2 + 2 + 2
    assert flash_attention.causal_pairs(4, window=8) == 10


def test_flash_launch():
    flops, nbytes = flash_attention.launch(2, 4, 3, 6, 2, 8)
    assert flops == 4 * 8 * 10 * 2 * 3
    assert nbytes == 2 * 2 * 4 * 8 * (3 + 2 * 2 + 6)


ARCH = {"hidden_size": 8, "head_dim": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "intermediate_size": 16,
        "vocab_size": 10, "num_hidden_layers": 2, "sliding_window": None}


def test_control_of_a_point():
    ctrl = subnet.control(dict(ARCH, intermediate_size=8960,
                               num_hidden_layers=28),
                          {"depth_frac": 0.75, "ffn_frac": 0.75,
                           "head_frac": 0.5, "topk": 0, "subnet_id": 9})
    assert sum(ctrl["gates"]) == 21 and ctrl["gates"][:21] == [True] * 21
    assert ctrl["ffn_width"] == 6656          # 52.5 rounds to even
    assert ctrl["head_width"] == 2            # one of two heads a group
    assert ctrl["subnet_id"] == 9


def test_useful_flops_dense():
    ctrl = {"gates": [True, False], "head_width": 2, "ffn_width": 8,
            "topk": 0}
    per_tok = 2 * 8 * 2 * (2 + 2 * 2 + 2) + 2 * 3 * 8 * 8
    per_row = 3 * per_tok + 4 * 2 * 2 * 6 + 2 * 8 * 10
    assert lm_step.useful_flops(ARCH, ctrl, rows=5, seq=3) == 5 * per_row


def test_launches_switch_and_mask():
    ctrl = {"gates": [True, True], "head_width": 2, "ffn_width": 8,
            "topk": 0}
    sw = lm_step.launches(ARCH, ctrl, "switch", 2, 4)
    assert len(sw["flash_attention"]) == 2 and len(sw["sliced_matmul"]) == 8
    assert sw["sliced_matmul"][0] == sliced_matmul.dense(8, 2 * 2, 8, 8)
    mask = lm_step.launches(ARCH, ctrl, "mask", 2, 4)
    assert mask["sliced_matmul"] == [] and len(mask["flash_attention"]) == 2
    assert mask["flash_attention"][0] == flash_attention.launch(
        2, 4, 4, 4, 2, 2)


def test_launches_moe_count_routed_rows():
    arch = dict(ARCH, num_local_experts=4, num_experts_per_tok=2,
                topk_options=[1, 2], capacity_factor=1.25)
    ctrl = {"gates": [True, False], "head_width": 4, "ffn_width": 8,
            "topk": 1}
    out = lm_step.launches(arch, ctrl, "switch", 2, 8)
    m = 16
    cap = subnet.capacity(arch, m)
    assert cap == 16                          # int(16*2*1.25/4) = 10 -> 16
    assert out["sliced_matmul.experts"] == [
        sliced_matmul.experts(4, m, cap, 8, 8, 16),
        sliced_matmul.experts(4, m, cap, 8, 8, 16),
        sliced_matmul.experts(4, m, cap, 8, 8, 8)]
    assert len(out["sliced_matmul"]) == 1     # wo


@pytest.mark.parametrize("n,cap", [(1, 8), (100, 32), (2048, 640)])
def test_capacity(n, cap):
    arch = {"num_experts_per_tok": 2, "topk_options": [1, 2],
            "capacity_factor": 1.25, "num_local_experts": 8}
    assert subnet.capacity(arch, n) == cap
