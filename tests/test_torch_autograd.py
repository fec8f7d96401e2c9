"""The gradients of the port's kernels (``repro_torch.kernels.autograd``)
on the CPU.

Each ``torch.autograd.Function`` runs here with its kernel's plain version
as the forward, in fp64: ``torch.autograd.gradcheck`` holds its
``*_backward_plain`` to finite differences of that forward, and the
backward equals ``torch.autograd`` of the plain forward to 1e-10.

* flash attention: causal, a window, ``kv_len`` (int and device tensor),
  GQA and MHA, ``head_width`` (inactive heads get no gradient);
* both SubnetNorm forms: the gain gradient lands in row ``subnet_id``
  only;
* ``sliced_matmul``: widths as 0-d tensors, ``segments`` > 1, a stack of
  experts, x of three dims;
* the dispatch: with a stand-in device check that sends CPU tensors to
  the ``cuda`` tier, the differentiable kernels go through their
  Functions (outputs have a ``grad_fn``, gradients equal the plain
  path's, the model's loss too, with and without ``remat``), and a
  kernel without a Function (``decode_attention``) raises under grad.
"""
import functools

import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro_torch import compat
from repro_torch.core import subnet as tsn
from repro_torch.kernels import autograd as ag
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.kernels import sliced_matmul as sm
from repro_torch.kernels import subnet_rmsnorm as rn
from repro_torch.kernels.dispatch import DISPATCHER
from repro_torch.models import lm as tlm
from repro_torch.models.common import tree_leaves
from test_torch_lm import port_cfg

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's many small ops: under the
    parallel test workers each extra thread only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, dtype=F64) * scale
            ).requires_grad_()


def _i32(v):
    return torch.tensor(v, dtype=torch.int32)


def _same_as_autograd(fn_ag, fn_plain, inputs):
    """The Function's gradients equal torch.autograd's of the plain forward
    on the same inputs and a seeded output gradient."""
    outs = fn_ag(*inputs)
    want_outs = fn_plain(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    want_outs = want_outs if isinstance(want_outs, tuple) else (want_outs,)
    assert all(o.grad_fn is not None for o in outs)
    gen = torch.Generator().manual_seed(1)
    dys = [torch.randn(o.shape, generator=gen, dtype=o.dtype) for o in outs]
    got = torch.autograd.grad(outs, inputs, dys)
    want = torch.autograd.grad(want_outs, inputs, dys)
    for o, w in zip(outs, want_outs):
        torch.testing.assert_close(o, w, rtol=0, atol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)
    return got


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

# (Hq, Hkv, S, causal, window, kv_len, head_width)
FLASH_CASES = {
    "causal-gqa": (4, 2, 6, True, 0, None, None),
    "window": (4, 2, 7, True, 3, None, None),
    "kv_len-int": (4, 2, 6, True, 0, 4, None),
    "kv_len-tensor-noncausal": (4, 2, 6, False, 0, "t3", None),
    "head_width-gqa": (4, 2, 5, True, 0, None, 2),
    "head_width-tensor": (4, 2, 5, True, 0, None, "t2"),
    "mha-head_width": (3, 3, 5, True, 0, None, 2),
    "fully-masked-rows": (2, 1, 5, True, 0, "t0", None),
}


def _ctl(v):
    return _i32(int(v[1:])) if isinstance(v, str) else v


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_backward_gradcheck(case):
    Hq, Hkv, S, causal, window, kv_len, hw = FLASH_CASES[case]
    kv_len, hw = _ctl(kv_len), _ctl(hw)
    gen = torch.Generator().manual_seed(len(case))
    q = _randn(gen, 2, Hq, S, 4)
    k = _randn(gen, 2, Hkv, S, 4)
    v = _randn(gen, 2, Hkv, S, 4)
    kw = dict(causal=causal, window=window, kv_len=kv_len, head_width=hw)
    # the chunked plain version, its kv blocks cut across the masks
    plain = functools.partial(fa.flash_attention_plain, q_block=2,
                              kv_block=3)

    def fn(q, k, v):
        return ag._FlashAttention.apply(plain, q, k, v, causal, window,
                                        kv_len, hw)

    assert torch.autograd.gradcheck(fn, (q, k, v))
    dq, dk, dv = _same_as_autograd(
        fn, lambda q, k, v: plain(q, k, v, **kw), (q, k, v))
    if hw is not None:
        idle = ~ref.head_active(Hq, Hkv, hw, q.device)
        assert idle.any() and (dq[:, idle] == 0).all()


def test_flash_backward_uses_the_saved_output():
    """The backward's row sums take the forward's o: on a bf16 forward
    (the card's type) it stays within bf16 tolerance of fp32 autograd."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(s, generator=gen) for s in
               ((2, 4, 9, 8), (2, 2, 9, 8), (2, 2, 9, 8)))
    do = torch.randn((2, 4, 9, 8), generator=gen)
    o16 = fa.flash_attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16())
    got = ag.flash_attention_backward_plain(
        q.bfloat16(), k.bfloat16(), v.bfloat16(), o16, do.bfloat16())
    qf, kf, vf = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(fa.flash_attention_plain(qf, kf, vf),
                               (qf, kf, vf), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w, rtol=2e-2, atol=2e-2)


# --------------------------------------------------------------------------
# SubnetNorm, both forms
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sid", [2, "t1"])
def test_rmsnorm_backward_gradcheck(sid):
    sid = _ctl(sid)
    gen = torch.Generator().manual_seed(5)
    x = _randn(gen, 3, 4, 8)
    gamma = (1 + 0.3 * torch.randn((4, 8), generator=gen, dtype=F64)
             ).requires_grad_()

    def fn(x, gamma):
        return ag._SubnetRMSNorm.apply(rn.subnet_rmsnorm_plain, x, gamma,
                                       sid, 1e-5)

    assert torch.autograd.gradcheck(fn, (x, gamma))
    _, dgamma = _same_as_autograd(
        fn, lambda x, g: rn.subnet_rmsnorm_plain(x, g, sid), (x, gamma))
    row = int(sid)
    assert dgamma[row].abs().sum() > 0
    assert (dgamma[torch.arange(4) != row] == 0).all()


@pytest.mark.parametrize("sid", [0, "t3"])
def test_add_rmsnorm_backward_gradcheck(sid):
    sid = _ctl(sid)
    gen = torch.Generator().manual_seed(6)
    x, delta = _randn(gen, 5, 8), _randn(gen, 5, 8)
    gamma = (1 + 0.3 * torch.randn((4, 8), generator=gen, dtype=F64)
             ).requires_grad_()

    def fn(x, delta, gamma):
        return ag._AddSubnetRMSNorm.apply(rn.add_subnet_rmsnorm_plain, x,
                                          delta, gamma, sid, 1e-5)

    assert torch.autograd.gradcheck(fn, (x, delta, gamma))
    dx, ddelta, dgamma = _same_as_autograd(
        fn, lambda x, d, g: rn.add_subnet_rmsnorm_plain(x, d, g, sid),
        (x, delta, gamma))
    assert torch.equal(dx, ddelta)
    row = int(sid)
    assert (dgamma[torch.arange(4) != row] == 0).all()


# --------------------------------------------------------------------------
# sliced_matmul
# --------------------------------------------------------------------------

# (x shape, w shape, active_in, active_out, segments)
SLICED_CASES = {
    "2d-ints": ((5, 16), (16, 12), 8, 4, 1),
    "2d-tensors": ((5, 16), (16, 12), "t8", "t4", 1),
    "segments": ((5, 16), (16, 12), "t3", None, 4),
    "x-3d": ((2, 3, 16), (16, 12), 5, "t7", 2),
    "experts": ((3, 4, 16), (3, 16, 12), "t8", "t5", 1),
    "full": ((4, 16), (16, 12), None, None, 1),
}


@pytest.mark.parametrize("case", list(SLICED_CASES))
def test_sliced_matmul_backward_gradcheck(case):
    xs, ws, ai, ao, segments = SLICED_CASES[case]
    ai, ao = _ctl(ai), _ctl(ao)
    gen = torch.Generator().manual_seed(7)
    x, w = _randn(gen, *xs), _randn(gen, *ws)

    def fn(x, w):
        return ag._SlicedMatmul.apply(sm.sliced_matmul_plain, x, w, ai, ao,
                                      segments)

    assert torch.autograd.gradcheck(fn, (x, w))
    dx, dw = _same_as_autograd(
        fn, lambda x, w: sm.sliced_matmul_plain(x, w, ai, ao,
                                                segments=segments), (x, w))
    K, N = ws[-2:]
    if ai is not None:
        dead_in = torch.arange(K) % (K // segments) >= ai
        assert (dx[..., dead_in] == 0).all()
        assert (dw[..., dead_in, :] == 0).all()
    if ao is not None:
        assert (dw[..., torch.arange(N) >= ao] == 0).all()


# --------------------------------------------------------------------------
# the dispatch: Functions on the cuda tier, the guard
# --------------------------------------------------------------------------


@pytest.fixture
def cpu_as_cuda(monkeypatch):
    """CPU tensors resolve to the ``cuda`` tier, and each kernel wrapper is
    its plain version: the cuda registrations run here, Functions and
    guard included."""
    monkeypatch.setattr(compat, "device_tier", lambda device: "cuda")
    monkeypatch.setattr(fa, "flash_attention", fa.flash_attention_plain)
    monkeypatch.setattr(rn, "subnet_rmsnorm", rn.subnet_rmsnorm_plain)
    monkeypatch.setattr(rn, "add_subnet_rmsnorm",
                        rn.add_subnet_rmsnorm_plain)
    monkeypatch.setattr(sm, "sliced_matmul", sm.sliced_matmul_plain)


def test_cuda_tier_kernels_go_through_their_functions(cpu_as_cuda):
    gen = torch.Generator().manual_seed(8)
    q, k, v = _randn(gen, 1, 4, 5, 4), _randn(gen, 1, 2, 5, 4), \
        _randn(gen, 1, 2, 5, 4)
    x, w = _randn(gen, 3, 16), _randn(gen, 16, 8)
    gamma = torch.ones((2, 16), dtype=F64, requires_grad=True)
    outs = [kops.flash_attention(q, k, v, head_width=_i32(2)),
            kops.sliced_matmul(x, w, _i32(8), _i32(4)),
            kops.subnet_rmsnorm(x, gamma, _i32(1)),
            *kops.add_subnet_rmsnorm(x, x * 2, gamma, _i32(1))]
    names = [type(o.grad_fn).__name__ for o in outs]
    assert names == ["_FlashAttentionBackward", "_SlicedMatmulBackward",
                     "_SubnetRMSNormBackward", "_AddSubnetRMSNormBackward",
                     "_AddSubnetRMSNormBackward"]
    # outside grad the wrappers are called bare
    with torch.no_grad():
        assert kops.flash_attention(q, k, v).grad_fn is None


def test_cuda_kernel_without_a_function_raises_under_grad(cpu_as_cuda):
    gen = torch.Generator().manual_seed(9)
    q = _randn(gen, 2, 4, 1, 8)
    cache = torch.randn((2, 2, 8, 8), dtype=F64)
    with pytest.raises(RuntimeError, match="decode_attention.*no backward"):
        kops.decode_attention(q, cache, cache, _i32(3))
    # a future kernel registered without a Function is guarded too
    DISPATCHER.register("stand_in", "cuda", lambda x: x.detach() * 2)
    try:
        with pytest.raises(RuntimeError, match="stand_in"):
            DISPATCHER.call("stand_in", q)
        with torch.no_grad():
            assert DISPATCHER.call("stand_in", q).shape == q.shape
        assert DISPATCHER.call("stand_in", q.detach()).shape == q.shape
    finally:
        DISPATCHER._impls.pop("stand_in")


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("mode", ["mask", "switch"])
def test_model_loss_grads_through_functions(monkeypatch, mode, remat):
    """tiny_dense's loss and every leaf's gradient on the cuda tier's
    wiring (Functions around plain forwards) equal the plain path's."""
    cfg = port_cfg(tiny_dense())
    params = tlm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    toks = np.random.default_rng(0).integers(0, 128, (2, 9))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ctrl = tsn.make_control(cfg, tsn.enumerate_space(cfg)[5])

    def grads():
        loss = tlm.loss_fn(params, cfg, batch, ctrl, slice_mode=mode,
                           remat=remat)
        return [loss] + list(torch.autograd.grad(loss, leaves,
                                                 allow_unused=True))

    want = grads()
    monkeypatch.setattr(compat, "device_tier", lambda device: "cuda")
    for mod, name in ((fa, "flash_attention"), (rn, "subnet_rmsnorm"),
                      (rn, "add_subnet_rmsnorm"), (sm, "sliced_matmul")):
        monkeypatch.setattr(mod, name, getattr(mod, name + "_plain"))
    got = grads()
    assert float(got[0].detach()) == float(want[0].detach())
    for g, w in zip(got[1:], want[1:]):
        assert (g is None) == (w is None)
        if g is not None:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
