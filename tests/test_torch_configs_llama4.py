"""llama4-maverick-400b-a17b's MoE twin against ``repro`` (split from
``test_torch_configs``, whose twins and test bodies it takes, so that the
files run on separate workers): its ``reduced()`` with experts of d_ff
512 (so that switch mode has three widths), top-1 with a shared expert in
the ``(attn, moe, attn, mlp)`` unit, runs forward, prefill and decode
steps against ``repro.models.lm`` for every subnet, in both WeightSlice
modes (fp32, 2e-3), and ``lm.from_jax_params`` converts its tree."""
import pytest

from test_torch_configs import (  # noqa: F401 - collected here too
    _build, one_thread, test_decode_steps_match_jax_for_every_subnet,
    test_forward_and_prefill_match_jax_for_every_subnet,
    test_from_jax_params_converts_each_tree)


@pytest.fixture(scope="module", params=["llama4-moe512"])
def model(request):
    return _build(request.param)


@pytest.fixture(scope="module", params=["llama4-moe512"])
def twin(request):
    return _build(request.param)
