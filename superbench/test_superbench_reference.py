"""The plain reference against the program's torch-tier forward at the
reduced size on the CPU: every Pareto subnet of the dense and the MoE
twin, both WeightSlice modes, MoE capacity dropping tokens; and the fp8
control, which strays where the program's float32 CPU path does not."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import subnet as sn
from repro_torch.core.pareto import pareto_subnets
from repro_torch.models import lm
from superbench import judge, subnet, tiny, weights
from superbench.reference import lm as ref

SEQ = 16


def _setup(name, seed=3):
    cfg = get_config(name).reduced()
    params = weights.make(lm.init_model(cfg, device="meta"), seed, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (3, SEQ),
                           generator=torch.Generator().manual_seed(seed))
    return cfg, params, tokens


def _program(cfg, params, tokens, point, mode):
    ctrl = sn.make_control(cfg, point.sub)
    with torch.no_grad():
        return lm.prefill(params, cfg, {"tokens": tokens}, ctrl,
                          slice_mode=mode)[:, 0].float()


def _points(arch):
    return arch["pareto"]


@pytest.mark.parametrize("name", ["qwen2-1.5b", "mixtral-8x7b"])
@pytest.mark.parametrize("mode", ["mask", "switch"])
def test_reference_equals_program_on_cpu(name, mode):
    cfg, params, tokens = _setup(name)
    arch = tiny.arch(name)
    for point, frozen in zip(pareto_subnets(cfg), _points(arch)):
        want = _program(cfg, params, tokens, point, mode)
        got = ref.last_logits(arch, params, [{"tokens": tokens,
                                              "point": frozen}])[0]
        err = (got - want).abs().max().item()
        assert err < 1e-4 * max(1.0, want.abs().max().item()), (point, err)


def test_reference_drops_by_capacity_as_the_program_does():
    cfg, params, _ = _setup("mixtral-8x7b", seed=5)
    arch = tiny.arch("mixtral-8x7b")
    # one token id everywhere: every row of a layer's input is alike, so
    # every token routes to the same two experts, past their capacity
    tokens = torch.full((3, SEQ), 7)
    h = torch.randn(1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0)).expand(3 * SEQ, -1)
    kept = ref.route(arch, h @ params["backbone"]["stages"][0]["1:moe"]
                     ["router"][0], 2, 3 * SEQ)
    cap = subnet.capacity(arch, 3 * SEQ)
    assert sorted(len(t) for t, _ in kept)[-2:] == [cap, cap] < [3 * SEQ]
    for point, frozen in zip(pareto_subnets(cfg), _points(arch)):
        want = _program(cfg, params, tokens, point, "switch")
        got = ref.last_logits(arch, params, [{"tokens": tokens,
                                              "point": frozen}])[0]
        assert (got - want).abs().max().item() < 1e-4 * max(
            1.0, want.abs().max().item())


def test_control_strays_where_the_program_does_not():
    cfg, params, tokens = _setup("qwen2-1.5b", seed=8)
    arch = tiny.arch("qwen2-1.5b")
    frozen = _points(arch)[-1]
    job = [{"tokens": tokens, "point": frozen, "rows": 3}]
    want = judge.reference_logits(arch, params, job)
    program = _program(cfg, params, tokens, pareto_subnets(cfg)[-1],
                       "switch").numpy()
    control = judge.reference_logits(arch, params, job, ref.fp8)
    lo = judge.readings(program, want)["logit_err_median"]
    hi = judge.readings(control, want)["logit_err_median"]
    assert lo < 1e-5 and hi > 1e-3, (lo, hi)


def test_fp8_rounds_each_output_channel_on_its_own_scale():
    w = torch.tensor([[1.0, 1000.0], [0.3, -700.0], [0.01, 3.0]])
    q = ref.fp8(w, -2)
    assert torch.allclose(q[:, 0], w[:, 0], rtol=0.07)
    assert torch.allclose(q[:, 1], w[:, 1], rtol=0.07)
    assert not torch.equal(q, w)
    assert np.isclose(q.abs().max(0).values.numpy(),
                      w.abs().max(0).values.numpy()).all()
