"""The port's weight-only int8 (``repro_torch.serving.quantize``) against the
JAX package's (``repro.serving.quantize``): every case of
``tests/test_quantize.py`` on the same ``tiny_dense(d_model=128, d_ff=512,
vocab_size=512)`` weights, built by JAX and copied across through numpy,
plus the int8 tree, the scales and both dequantizations equal to JAX's
bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro.core import subnet as jsn
from repro.models import lm as jlm
from repro.serving import quantize as JQ
from repro_torch.core import subnet as tsn
from repro_torch.models import lm as tlm
from repro_torch.models.common import tree_leaves
from repro_torch.serving import quantize as QZ
from test_torch_lm import port_cfg, port_params


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def supernet():
    jcfg = tiny_dense(d_model=128, d_ff=512, vocab_size=512)
    jparams = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, port_cfg(jcfg), jparams, port_params(jparams)


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_int8_tree_and_scales_equal_jax(supernet):
    _, _, jparams, params = supernet
    jq, jsc = JQ.quantize_tree(jparams)
    q, sc = QZ.quantize_tree(params)
    jl, tl = jax.tree.leaves(jq), tree_leaves(q)
    assert len(jl) == len(tl)
    n_int8 = 0
    for a, b in zip(jl, tl):
        assert str(np.asarray(a).dtype) == str(b.dtype).replace("torch.", "")
        np.testing.assert_array_equal(_np(b), _jnp(a))
        n_int8 += b.dtype == torch.int8
    assert n_int8 >= 4
    for a, b in zip(jax.tree.leaves(jsc), tree_leaves(sc)):
        assert b.dtype == torch.float32 and tuple(b.shape) == np.shape(a)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_equals_jax(supernet, dtype):
    _, _, jparams, params = supernet
    jq, jsc = JQ.quantize_tree(jparams)
    q, sc = QZ.quantize_tree(params)
    jd = JQ.dequantize_tree(jq, jsc, dtype=getattr(jnp, dtype))
    td = QZ.dequantize_tree(q, sc, dtype=getattr(torch, dtype))
    for a, b in zip(jax.tree.leaves(jd), tree_leaves(td)):
        np.testing.assert_array_equal(_np(b), _jnp(a))


def test_roundtrip_error_bound(supernet):
    _, _, _, params = supernet
    q, sc = QZ.quantize_tree(params)
    deq = QZ.dequantize_tree(q, sc, dtype=torch.float32)
    for a, b in zip(tree_leaves(params), tree_leaves(deq)):
        a, b = a.float().numpy(), b.float().numpy()
        if a.ndim >= 2 and a.size >= QZ.MIN_ELEMS:
            # per-channel symmetric int8: |err| <= scale/2 = amax/254
            amax = np.abs(a).max(axis=tuple(range(a.ndim - 1)),
                                 keepdims=True)
            assert (np.abs(a - b) <= amax / 254 + 1e-7).all()
        else:
            np.testing.assert_array_equal(a, b)


def test_wire_bytes_halved(supernet):
    _, _, jparams, params = supernet
    q, sc = QZ.quantize_tree(params)
    orig = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    wire = QZ.quantized_bytes(q) + QZ.quantized_bytes(sc)
    assert wire < 0.65 * orig
    jq, jsc = JQ.quantize_tree(jparams)
    assert wire == JQ.quantized_bytes(jq) + JQ.quantized_bytes(jsc)


def test_decode_logits_close(supernet):
    """int8 decode tracks the full-precision decode as the reference's
    does, and equals JAX's int8 decode on the same dequantized weights."""
    jcfg, cfg, jparams, params = supernet
    ctrl = tsn.make_control(cfg, tsn.max_subnet(cfg))
    toks = torch.ones((2, 1), dtype=torch.int64)
    cache = tlm.init_cache(cfg, 2, 16, device="cpu")
    ref, _ = tlm.decode_step(params, cfg, toks, ctrl, cache, 0)
    q, sc = QZ.quantize_tree(params)
    deq = QZ.dequantize_tree(q, sc, dtype=torch.float32)
    cache = tlm.init_cache(cfg, 2, 16, device="cpu")
    got, _ = tlm.decode_step(deq, cfg, toks, ctrl, cache, 0)
    err = float((ref.float() - got.float()).abs().max())
    assert err < 0.25, err
    jq, jsc = JQ.quantize_tree(jparams)
    jdeq = JQ.dequantize_tree(jq, jsc, dtype=jnp.float32)
    jctrl = jsn.make_control(jcfg, jsn.max_subnet(jcfg))
    jgot, _ = jlm.decode_step(jdeq, jcfg, jnp.ones((2, 1), jnp.int32), jctrl,
                              jlm.init_cache(jcfg, 2, 16), jnp.int32(0))
    want = np.asarray(jgot, np.float32)
    gap = float(np.abs(got.float().numpy() - want).max())
    assert gap <= 2e-3 * max(1.0, float(np.abs(want).max())), gap


def test_quantize_specs_match_tree(supernet):
    _, cfg, _, params = supernet
    specs = tlm.init_model(cfg, device="meta")
    q_sp, sc_sp = QZ.quantize_specs(specs)
    q, sc = QZ.quantize_tree(params)
    for a, b in zip(tree_leaves(q_sp), tree_leaves(q)):
        assert a.is_meta and a.shape == b.shape and a.dtype == b.dtype
    for a, b in zip(tree_leaves(sc_sp), tree_leaves(sc)):
        assert a.is_meta and tuple(a.shape) == tuple(b.shape)


def test_subnetact_commutes_with_quantization(supernet):
    """Quantize-then-actuate == actuate-then-quantize at the logits level
    (per-channel scales align with WeightSlice axes)."""
    _, cfg, _, params = supernet
    q, sc = QZ.quantize_tree(params)
    deq = QZ.dequantize_tree(q, sc, dtype=torch.float32)
    batch = {"tokens": torch.ones((1, 8), dtype=torch.int64)}
    for sub in (tsn.min_subnet(cfg), tsn.max_subnet(cfg)):
        ctrl = tsn.make_control(cfg, sub)
        a = tlm.forward(params, cfg, batch, ctrl)
        b = tlm.forward(deq, cfg, batch, ctrl)
        assert float((a.float() - b.float()).abs().max()) < 0.3
