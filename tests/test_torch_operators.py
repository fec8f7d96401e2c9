"""SubNetAct operators of the PyTorch port against repro.core.operators on
the same numpy inputs (fp32, tolerance 2e-3 as in tests/test_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as jops
from repro_torch.core import operators as ops

TOL = dict(rtol=2e-3, atol=2e-3)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kind,beta", [("rmsnorm", False),
                                       ("layernorm", False),
                                       ("layernorm", True)])
@pytest.mark.parametrize("sid", [0, 3])
def test_subnet_norm_matches_jax(kind, beta, sid):
    x, gamma = _x((2, 5, 64)), 1 + 0.1 * _x((4, 64), 1)
    bt = 0.1 * _x((4, 64), 2) if beta else None
    want = jops.subnet_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.int32(sid),
                            beta_table=None if bt is None else jnp.asarray(bt),
                            kind=kind)
    got = ops.subnet_norm(torch.from_numpy(x), torch.from_numpy(gamma),
                          torch.tensor(sid, dtype=torch.int32),
                          beta_table=None if bt is None else torch.from_numpy(bt),
                          kind=kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,beta", [("rmsnorm", False),
                                       ("layernorm", False),
                                       ("layernorm", True)])
@pytest.mark.parametrize("sid", [0, 3])
def test_subnet_norm_with_residual_matches_jax(kind, beta, sid, dtype):
    """With ``residual`` the norm takes the pending add first and returns
    ``(s, h)``: ``s`` is exactly ``x + residual`` in the working type and
    ``h`` matches JAX's norm of that sum (2e-3 in fp32, 2e-2 in bf16)."""
    x, r = _x((2, 5, 64)), _x((2, 5, 64), 3)
    gamma = 1 + 0.1 * _x((4, 64), 1)
    bt = 0.1 * _x((4, 64), 2) if beta else None
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jr = jnp.asarray(r).astype(getattr(jnp, dtype))
    want = jops.subnet_norm(jx + jr, jnp.asarray(gamma), jnp.int32(sid),
                            beta_table=None if bt is None else jnp.asarray(bt),
                            kind=kind)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tr = torch.from_numpy(r).to(getattr(torch, dtype))
    s, h = ops.subnet_norm(tx, torch.from_numpy(gamma),
                           torch.tensor(sid, dtype=torch.int32),
                           beta_table=None if bt is None else torch.from_numpy(bt),
                           kind=kind, residual=tr)
    assert torch.equal(s, tx + tr) and h.dtype == tx.dtype
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray((jx + jr).astype(jnp.float32)))
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(h.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("active,axis", [(0, -1), (5, -1), (64, -1), (3, 1)])
def test_slice_mask_matches_jax(active, axis):
    x = _x((2, 7, 64))
    want = jops.slice_mask(jnp.asarray(x), jnp.int32(active), axis=axis)
    got = ops.slice_mask(torch.from_numpy(x),
                         torch.tensor(active, dtype=torch.int32), axis=axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ai,ao", [(128, 96), (64, 96), (40, 17), (None, 50),
                                   (70, None)])
def test_sliced_matmul_mask_mode_matches_jax(ai, ao):
    x, w = _x((3, 4, 128)), _x((128, 96), 1)
    want = jops.sliced_matmul(jnp.asarray(x), jnp.asarray(w),
                              None if ai is None else jnp.int32(ai),
                              None if ao is None else jnp.int32(ao),
                              mode="mask")
    got = ops.sliced_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            None if ai is None else torch.tensor(ai),
                            None if ao is None else torch.tensor(ao))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


SWITCH_OPTIONS = {
    "zipped": ((32, 64, 128), (24, 48, 96)),
    "in-only": ((40, 128), ()),
    "out-only": ((), (17, 50, 96)),
    "one-in-many-out": ((64,), (48, 96)),
}


@pytest.mark.parametrize("bucket", [-1, 0, 1, 2, 5])
@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("opts", list(SWITCH_OPTIONS))
def test_sliced_matmul_switch_mode_matches_jax(opts, as_tensor, bucket):
    """Switch mode: the bucket (clipped) picks the zipped (in, out) widths
    from the option lists, as JAX's lax.switch branches do; a bucket
    tensor is read as data through the device option table."""
    ins, outs = SWITCH_OPTIONS[opts]
    x, w = _x((3, 4, 128)), _x((128, 96), 1)
    want = jops.sliced_matmul(jnp.asarray(x), jnp.asarray(w), None, None,
                              mode="switch", in_options=ins,
                              out_options=outs, bucket=jnp.int32(bucket))
    b = torch.tensor(bucket, dtype=torch.int32) if as_tensor else bucket
    got = ops.sliced_matmul(torch.from_numpy(x), torch.from_numpy(w), None,
                            None, mode="switch", in_options=ins,
                            out_options=outs, bucket=b)
    assert got.shape == (3, 4, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sliced_matmul_switch_mode_is_not_ported():
    """The name predates the switch-mode port: both WeightSlice modes run
    now, and any other mode raises ValueError, as in the JAX package."""
    x, w = torch.ones((2, 8)), torch.ones((8, 4))
    for mode in ops.SLICE_MODES:
        ops.check_slice_mode(mode)
    assert torch.equal(ops.sliced_matmul(x, w, None, None, mode="switch",
                                         bucket=0), x @ w)
    with pytest.raises(ValueError, match="unknown WeightSlice mode"):
        ops.sliced_matmul(x, w, 8, 4, mode="bogus")
    with pytest.raises(ValueError, match="unknown WeightSlice mode"):
        ops.check_slice_mode("mask ")


def test_layer_select_gates_on_host_value():
    calls = []

    def block(x):
        calls.append(1)
        return x + 1

    x = torch.zeros(3)
    assert torch.equal(ops.layer_select(np.bool_(False), block, x), x)
    assert not calls
    assert torch.equal(ops.layer_select(np.bool_(True), block, x), x + 1)
    assert calls == [1]


def test_device_control_splits_host_gates_from_device_values():
    from repro_torch.configs import get_config
    from repro_torch.core import subnet as sn
    cfg = get_config("qwen2-1.5b").reduced()
    ctrl = sn.make_control(cfg, sn.max_subnet(cfg))
    dc = ops.device_control(ctrl, "cpu")
    assert isinstance(dc["layer_gate"], np.ndarray)
    assert dc["layer_gate"].dtype == bool
    for k, v in ctrl.items():
        if k != "layer_gate":
            assert isinstance(dc[k], torch.Tensor) and dc[k].dim() == 0
            assert dc[k].dtype == torch.int32 and int(dc[k]) == int(v)
    # already converted: passes through unchanged
    again = ops.device_control(dc, "cpu")
    assert all(again[k] is dc[k] for k in dc if k != "layer_gate")
    with pytest.raises(TypeError):
        ops.device_control({"layer_gate": torch.ones(2, dtype=torch.bool)},
                           "cpu")
