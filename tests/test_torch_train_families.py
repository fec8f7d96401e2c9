"""The port's loss and gradients against
``jax.value_and_grad(repro.models.lm.loss_fn)`` beyond the dense family:
one subnet each of the reduced mixtral-8x7b (capacity dispatch, the fp32
router, elastic top-k), zamba2-2.7b (Mamba2 units and the weight-shared
attention + MLP block) and xlstm-125m (mLSTM and sLSTM), in mask mode,
with the weights of ``lm.init_model`` copied across through numpy (fp32,
2e-3 of each leaf's largest gradient). The helpers are
``tests/test_torch_training.py``'s.
"""
import jax
import pytest

from repro.configs import get_config as jget_config
from repro_torch.core import subnet as tsn
from test_torch_training import (TOL, Model, _batch, _close,  # noqa: F401
                                 _port_loss_and_grads, one_thread)


FAMILY_CFGS = {
    "mixtral-8x7b": lambda: jget_config("mixtral-8x7b").reduced(),
    "zamba2-2.7b": lambda: jget_config("zamba2-2.7b").reduced(),
    "xlstm-125m": lambda: jget_config("xlstm-125m").reduced(),
}


@pytest.mark.parametrize("name", list(FAMILY_CFGS))
def test_loss_and_grads_match_jax_families(name):
    m = Model(FAMILY_CFGS[name]())
    # a middle subnet at the largest k: at k = 1 the one gate is 1 whatever
    # the router says, and the router's gradient is rounding noise
    space = [s for s in tsn.enumerate_space(m.tcfg)
             if s.topk == max(x.topk for x in tsn.enumerate_space(m.tcfg))]
    ctrl = tsn.make_control(m.tcfg, space[len(space) // 2])
    batch = _batch(m.tcfg.vocab_size, B=2, S=8)
    want_loss, want = m.jax_loss_and_grads(batch, ctrl, "mask")
    loss, got = _port_loss_and_grads(m, m.tparams(), batch, ctrl)
    assert loss == pytest.approx(want_loss, rel=TOL)
    _close(got, jax.tree.leaves(want), name)
