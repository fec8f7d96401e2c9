"""Kernel parity for the PyTorch port: each plain version (the ``torch``
tier that CPU tensors take) against the JAX Pallas kernel run in interpret
mode and against the JAX dense oracle, on the sweep shapes of
tests/test_kernels.py, and the device-decided dispatch rules. The
hand-written kernels themselves are checked on the card by
tests/test_torch_kernels_cuda.py.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances are those of tests/test_kernels.py: 2e-3 in fp32, 2e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import compat
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sliced_matmul as sm
from repro_torch.kernels import subnet_rmsnorm as rn
from repro_torch.kernels.dispatch import DISPATCHER, KernelDispatcher

DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-3, atol=2e-3)


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a CPU torch tensor."""
    a = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


# --------------------------------------------------------------------------
# plain versions against the JAX kernels (interpret) and dense oracles
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,d", [
    (1, 4, 2, 64, 64, 32),
    (2, 8, 8, 100, 100, 64),
    (1, 4, 1, 32, 128, 32),
])
def test_flash_attention_plain_matches_jax(B, Hq, Hkv, Sq, Sk, d, dtype):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng, (B, Hq, Sq, d), dtype)
    jk, tk = _pair(rng, (B, Hkv, Sk, d), dtype)
    jv, tv = _pair(rng, (B, Hkv, Sk, d), dtype)
    for window in (0, 16):
        for kv_len in (None, Sk // 2):
            want_d = jref.flash_attention_dense_ref(
                jq, jk, jv, causal=True, window=window, kv_len=kv_len)
            # kv_len as device data, the way a traced length reaches it
            t_len = (None if kv_len is None
                     else torch.tensor(kv_len, dtype=torch.int32))
            got = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                                      kv_len=t_len, q_block=32, kv_block=32)
            _close(got, want_d, dtype)
            if dtype == "float32" and (window == 0) == (kv_len is None):
                # the interpreted Pallas kernel compiles per dtype and
                # static (window, kv_len): hold the plain version against
                # it in fp32 on the two corner cases, against the oracle
                # on all eight
                want_k = jops.flash_attention(jq, jk, jv, causal=True,
                                              window=window, kv_len=kv_len,
                                              q_block=32, kv_block=32,
                                              tier="interpret")
                _close(got, want_k, dtype)
            dense = ref.flash_attention_dense_ref(
                tq, tk, tv, causal=True, window=window, kv_len=kv_len)
            _close(dense, want_d, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bucket", [0, 1])
@pytest.mark.parametrize("kind", ["gqa", "mha"])
def test_flash_attention_head_width_matches_jax_on_active_heads(kind, bucket,
                                                                dtype):
    """``head_width`` (an int, and a 0-d int32 tensor as switch mode passes
    it) against JAX's flash_attention run on the active heads only, sliced
    as the JAX switch branch slices them (``repro/models/attention.py``,
    ``attention_block``): under GQA a prefix of every kv group, under MHA a
    prefix of the heads with their kv heads. Interpret-mode Pallas in fp32
    and the dense oracle in both dtypes; inactive heads exactly 0. Every
    head bucket of ``tiny_dense``."""
    from conftest import tiny_dense
    from repro.core.subnet import width_options
    jcfg = tiny_dense() if kind == "gqa" else tiny_dense(n_kv_heads=4)
    Hq, Hkv, d = jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim
    G, B, S = Hq // Hkv, 2, 12
    hw = width_options(jcfg)["heads"][bucket]
    rng = np.random.default_rng(6)
    jq, tq = _pair(rng, (B, Hq, S, d), dtype)
    jk, tk = _pair(rng, (B, Hkv, S, d), dtype)
    jv, tv = _pair(rng, (B, Hkv, S, d), dtype)
    if G > 1:
        a = hw // Hkv
        qs = jq.reshape(B, Hkv, G, S, d)[:, :, :a].reshape(B, Hkv * a, S, d)
        ks, vs = jk, jv
        act = [j * G + h for j in range(Hkv) for h in range(a)]
    else:
        qs, ks, vs = jq[:, :hw], jk[:, :hw], jv[:, :hw]
        act = list(range(hw))
    idle = [h for h in range(Hq) if h not in act]
    wants = [jref.flash_attention_dense_ref(qs, ks, vs, causal=True)]
    if dtype == "float32":
        wants.append(jops.flash_attention(qs, ks, vs, causal=True, q_block=8,
                                          kv_block=8, tier="interpret"))
    for width in (hw, torch.tensor(hw, dtype=torch.int32)):
        got = ops.flash_attention(tq, tk, tv, causal=True, head_width=width,
                                  q_block=8, kv_block=8)
        for want in wants:
            _close(got[:, act], want, dtype)
        assert (got[:, idle] == 0).all()


def test_flash_attention_q_offset_and_scale_take_plain_path():
    """ops.py:173 rule: q_offset / scale calls take the plain path; the
    offset shifts the causal frontier like the JAX blockwise path."""
    from repro.models.attention import flash_attention as jflash
    rng = np.random.default_rng(1)
    jq, tq = _pair(rng, (1, 4, 16, 32), "float32")
    jk, tk = _pair(rng, (1, 2, 48, 32), "float32")
    jv, tv = _pair(rng, (1, 2, 48, 32), "float32")
    want = jflash(jq, jk, jv, causal=True, q_offset=32, scale=0.1,
                  q_block=8, kv_block=16)
    got = ops.model_flash_attention(tq, tk, tv, causal=True, q_offset=32,
                                    scale=0.1, q_block=8, kv_block=16)
    _close(got, want, "float32")


@pytest.mark.parametrize("kwargs", [dict(q_offset=1), dict(scale=0.1)])
def test_flash_attention_q_offset_and_scale_off_cpu_raise(kwargs):
    """Off the CPU, q_offset / scale never reach the plain version: the
    device alone decides, and the kernel takes neither argument."""
    q = torch.empty((1, 4, 16, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError, match="q_offset / scale"):
        ops.model_flash_attention(q, q[:, :2], q[:, :2], **kwargs)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,Smax,d", [(2, 4, 2, 128, 32),
                                             (1, 8, 1, 96, 64)])
def test_decode_attention_plain_matches_jax(B, Hq, Hkv, Smax, d, dtype):
    rng = np.random.default_rng(2)
    jq, tq = _pair(rng, (B, Hq, 1, d), dtype)
    jk, tk = _pair(rng, (B, Hkv, Smax, d), dtype)
    jv, tv = _pair(rng, (B, Hkv, Smax, d), dtype)
    for idx in (0, 5, Smax - 1):
        for window in (0, 16):
            want_d = jref.decode_attention_dense_ref(jq, jk, jv, idx,
                                                     window=window)
            t_idx = torch.tensor(idx, dtype=torch.int32)
            got = ops.decode_attention(tq, tk, tv, t_idx, window=window,
                                       kv_block=32)
            _close(got, want_d, dtype)
            if dtype == "float32":
                # the index is traced: one interpreted kernel per window
                want_k = jops.decode_attention(jq, jk, jv, jnp.int32(idx),
                                               window=window, kv_block=32,
                                               tier="interpret")
                _close(got, want_k, dtype)
            _close(ref.decode_attention_dense_ref(tq, tk, tv, t_idx,
                                                  window=window),
                   want_d, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,d,S", [(64, 128, 4), (100, 256, 9), (7, 512, 2)])
def test_subnet_rmsnorm_plain_matches_jax(M, d, S, dtype):
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng, (M, d), dtype)
    jg, tg = _pair(rng, (S, d), "float32")
    for sid in (0, S - 1):
        want_k = jops.subnet_rmsnorm(jx, jg, jnp.int32(sid), tier="interpret")
        want_d = jref.subnet_rmsnorm_ref(jx, jg, sid)
        got = ops.subnet_rmsnorm(tx, tg, torch.tensor(sid, dtype=torch.int32))
        _close(got, want_k, dtype)
        _close(got, want_d, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,d,S", [(64, 128, 4), (100, 256, 9), (7, 512, 2)])
def test_add_subnet_rmsnorm_plain_matches_jax(M, d, S, dtype):
    """The fused form through ``ops`` against JAX ``x + y`` followed by the
    Pallas kernel (interpret) and the dense oracle; its sum is exactly
    ``x + y`` in the working type."""
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng, (M, d), dtype)
    jy, ty = _pair(rng, (M, d), dtype)
    jg, tg = _pair(rng, (S, d), "float32")
    js = jx + jy
    for sid in (0, S - 1):
        want_k = jops.subnet_rmsnorm(js, jg, jnp.int32(sid), tier="interpret")
        want_d = jref.subnet_rmsnorm_ref(js, jg, sid)
        s, h = ops.add_subnet_rmsnorm(tx, ty, tg,
                                      torch.tensor(sid, dtype=torch.int32))
        assert s.dtype == tx.dtype and h.dtype == tx.dtype
        assert torch.equal(s, tx + ty)
        np.testing.assert_array_equal(_np(s), _np(js))
        _close(h, want_k, dtype)
        _close(h, want_d, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N", [(64, 256, 384), (8, 128, 128)])
def test_sliced_matmul_plain_matches_jax(M, K, N, dtype):
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng, (M, K), dtype)
    jw, tw = _pair(rng, (K, N), dtype)
    for ai, ao in ((K, N), (128, 128), (K // 2, N)):
        want_k = jops.sliced_matmul(jx, jw, jnp.int32(ai), jnp.int32(ao),
                                    tier="interpret")
        want_d = jref.sliced_matmul_ref(jx, jw, ai, ao)
        got = ops.sliced_matmul(tx, tw, torch.tensor(ai), torch.tensor(ao))
        _close(got, want_k, dtype)
        _close(got, want_d, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N", [(7, 200, 96), (16, 256, 100)])
def test_sliced_matmul_plain_matches_ref_at_partial_widths(M, K, N, dtype):
    """Widths that cut a tile (the kernel's boundary cases) against the
    JAX dense oracle and the port's, as ints and as 0-d tensors."""
    rng = np.random.default_rng(8)
    jx, tx = _pair(rng, (M, K), dtype)
    jw, tw = _pair(rng, (K, N), dtype)
    for ai, ao in ((K, N), (K - 56, N - 3), (1, 1), (0, N), (K, 0)):
        want = jref.sliced_matmul_ref(jx, jw, ai, ao)
        for a, b in ((ai, ao), (torch.tensor(ai, dtype=torch.int32),
                                torch.tensor(ao, dtype=torch.int32))):
            got = sm.sliced_matmul_plain(tx, tw, a, b)
            _close(got, want, dtype)
            _close(got, ref.sliced_matmul_ref(tx, tw, a, b), dtype)
            assert not got[:, ao:].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv,group,hd", [(2, 6, 16), (2, 2, 16), (4, 3, 8)])
def test_sliced_matmul_segments_match_jax_gqa_projection(kv, group, hd, dtype):
    """``segments=kv`` computes the GQA output projection of JAX's switch
    branch (repro/models/attention.py): o of the first ``a`` heads of every
    KV group against those heads' rows of wo."""
    M, d = 10, 48
    rng = np.random.default_rng(9)
    jo, to = _pair(rng, (M, kv * group * hd), dtype)
    jw, tw = _pair(rng, (kv * group * hd, d), dtype)
    for a in range(1, group + 1):
        os_ = jo.reshape(M, kv, group, hd)[:, :, :a].reshape(M, kv * a * hd)
        ws = jw.reshape(kv, group, hd, d)[:, :a].reshape(kv * a * hd, d)
        want = jnp.matmul(os_.astype(jnp.float32), ws.astype(jnp.float32))
        got = ops.sliced_matmul(to, tw, torch.tensor(a * hd), None,
                                segments=kv)
        assert got.dtype == to.dtype and got.shape == (M, d)
        _close(got, want, dtype)


# --------------------------------------------------------------------------
# the head dims of the other dense configs: 80 (stablelm-3b, MHA) and 120
# (h2o-danube-3-4b, G = 4), with G = 1, 4 and 5 (qwen2.5-14b's group)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G", [1, 4, 5])
@pytest.mark.parametrize("d", [80, 120])
def test_flash_attention_plain_matches_jax_at_head_dims(d, G, dtype):
    """The plain version at d = 80 and 120 over 2 kv heads, with a window
    and ``kv_len`` (a device int), against JAX's dense oracle, and against
    the Pallas kernel in interpret mode in fp32 on the corner cases, as
    :func:`test_flash_attention_plain_matches_jax` runs it."""
    B, Hkv, S = 1, 2, 40
    rng = np.random.default_rng(d + G)
    jq, tq = _pair(rng, (B, G * Hkv, S, d), dtype)
    jk, tk = _pair(rng, (B, Hkv, S, d), dtype)
    jv, tv = _pair(rng, (B, Hkv, S, d), dtype)
    for window, kv_len in ((0, None), (16, 25), (16, None)):
        want_d = jref.flash_attention_dense_ref(
            jq, jk, jv, causal=True, window=window, kv_len=kv_len)
        t_len = (None if kv_len is None
                 else torch.tensor(kv_len, dtype=torch.int32))
        got = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                                  kv_len=t_len, q_block=16, kv_block=16)
        _close(got, want_d, dtype)
        if dtype == "float32" and (window == 0) == (kv_len is None):
            want_k = jops.flash_attention(jq, jk, jv, causal=True,
                                          window=window, kv_len=kv_len,
                                          q_block=16, kv_block=16,
                                          tier="interpret")
            _close(got, want_k, dtype)


@pytest.mark.parametrize("G", [1, 4, 5])
@pytest.mark.parametrize("d", [80, 120])
def test_flash_attention_head_width_matches_jax_at_head_dims(d, G):
    """``head_width`` at d = 80 and 120: the active heads (a prefix of
    each kv group under GQA, of the heads under MHA) against JAX's
    flash_attention on those heads alone, in interpret mode (fp32);
    inactive heads exactly 0."""
    B, Hkv, S = 1, 2 if G > 1 else 4, 12
    Hq = G * Hkv
    rng = np.random.default_rng(30 + d + G)
    jq, tq = _pair(rng, (B, Hq, S, d), "float32")
    jk, tk = _pair(rng, (B, Hkv, S, d), "float32")
    jv, tv = _pair(rng, (B, Hkv, S, d), "float32")
    if G > 1:
        a = max(1, round(G * 0.5))
        hw = a * Hkv
        qs = jq.reshape(B, Hkv, G, S, d)[:, :, :a].reshape(B, Hkv * a, S, d)
        ks, vs = jk, jv
        act = [j * G + h for j in range(Hkv) for h in range(a)]
    else:
        hw = Hq // 2
        qs, ks, vs = jq[:, :hw], jk[:, :hw], jv[:, :hw]
        act = list(range(hw))
    idle = [h for h in range(Hq) if h not in act]
    want = jops.flash_attention(qs, ks, vs, causal=True, q_block=8,
                                kv_block=8, tier="interpret")
    got = ops.flash_attention(tq, tk, tv, causal=True,
                              head_width=torch.tensor(hw, dtype=torch.int32),
                              q_block=8, kv_block=8)
    _close(got[:, act], want, "float32")
    assert (got[:, idle] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G", [1, 4, 5])
@pytest.mark.parametrize("d", [80, 120])
def test_decode_attention_plain_matches_jax_at_head_dims(d, G, dtype):
    """The plain decode at d = 80 and 120 over 2 kv heads, every index
    class and a window that wraps, against JAX's dense oracle, and the
    Pallas kernel in interpret mode in fp32; the kernel's split-then-merge
    arithmetic (``split_merge``) against the same oracle."""
    B, Hkv, Smax = 2, 2, 48
    rng = np.random.default_rng(40 + d + G)
    jq, tq = _pair(rng, (B, G * Hkv, 1, d), dtype)
    jk, tk = _pair(rng, (B, Hkv, Smax, d), dtype)
    jv, tv = _pair(rng, (B, Hkv, Smax, d), dtype)
    for idx in (0, 20, Smax - 1):
        for window in (0, 16):
            want_d = jref.decode_attention_dense_ref(jq, jk, jv, idx,
                                                     window=window)
            t_idx = torch.tensor(idx, dtype=torch.int32)
            got = ops.decode_attention(tq, tk, tv, t_idx, window=window,
                                       kv_block=16)
            _close(got, want_d, dtype)
            if dtype == "float32":
                want_k = jops.decode_attention(jq, jk, jv, jnp.int32(idx),
                                               window=window, kv_block=16,
                                               tier="interpret")
                _close(got, want_k, dtype)
                _close(da.split_merge(tq, tk, tv, idx, window=window,
                                      n_split=3), want_d, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv,group,hd", [(2, 4, 120), (4, 1, 80),
                                         (2, 5, 128)])
def test_sliced_matmul_segments_match_jax_gqa_projection_at_head_dims(
        kv, group, hd, dtype):
    """Segments of 480 (h2o-danube-3-4b's 4 heads of 120 a kv group) and
    of 80 (one head of stablelm-3b's width a segment), and qwen2.5-14b's
    5 heads of 128: the port's segmented product against JAX's GQA output
    projection on the first ``a`` heads of every segment."""
    M, d = 6, 32
    rng = np.random.default_rng(50 + hd)
    jo, to = _pair(rng, (M, kv * group * hd), dtype)
    jw, tw = _pair(rng, (kv * group * hd, d), dtype)
    for a in range(1, group + 1):
        os_ = jo.reshape(M, kv, group, hd)[:, :, :a].reshape(M, kv * a * hd)
        ws = jw.reshape(kv, group, hd, d)[:, :a].reshape(kv * a * hd, d)
        want = jnp.matmul(os_.astype(jnp.float32), ws.astype(jnp.float32))
        got = sm.sliced_matmul_plain(to, tw, torch.tensor(a * hd), None,
                                     segments=kv)
        assert got.dtype == to.dtype and got.shape == (M, d)
        _close(got, want, dtype)


# --------------------------------------------------------------------------
# device-decided dispatch: no fallback in either direction
# --------------------------------------------------------------------------


def test_cpu_tensor_takes_the_torch_tier():
    for name in ("flash_attention", "decode_attention", "subnet_rmsnorm",
                 "add_subnet_rmsnorm", "sliced_matmul"):
        tier, _ = DISPATCHER.resolve(name, torch.device("cpu"))
        assert tier == "torch"


def test_cuda_tensor_forced_to_torch_tier_raises():
    with pytest.raises(RuntimeError, match="takes the 'cuda' tier"):
        DISPATCHER.resolve("flash_attention", torch.device("cuda"),
                           tier="torch")


def test_cpu_tensor_forced_to_cuda_tier_raises():
    x = torch.ones((4, 8))
    g = torch.ones((2, 8))
    with pytest.raises(RuntimeError, match="takes the 'torch' tier"):
        ops.subnet_rmsnorm(x, g, torch.tensor(0, dtype=torch.int32),
                           tier="cuda")


def test_unported_kernel_raises_on_cuda():
    """Every kernel of the registry has its CUDA tier, sliced_matmul
    included; a kernel registered without one raises on a CUDA device."""
    for name in DISPATCHER.kernels():
        tier, fn = DISPATCHER.resolve(name, torch.device("cuda"))
        assert tier == "cuda" and fn is DISPATCHER._impls[name]["cuda"]
    assert DISPATCHER.registered_tiers("sliced_matmul") == ("cuda", "torch")
    reg = KernelDispatcher()
    reg.register("plain_only", "torch", lambda x: x)
    with pytest.raises(KeyError, match="no 'cuda' implementation"):
        reg.resolve("plain_only", torch.device("cuda"))


def test_pinned_tier_is_checked(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_KERNEL_TIER", "bogus")
    with pytest.raises(ValueError):
        compat.explicit_kernel_tier()
    monkeypatch.setenv("REPRO_TORCH_KERNEL_TIER", "torch")
    assert compat.explicit_kernel_tier() == "torch"
    with pytest.raises(RuntimeError):
        DISPATCHER.resolve("flash_attention", torch.device("cuda"))
    monkeypatch.delenv("REPRO_TORCH_KERNEL_TIER")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="unavailable"):
            compat.set_kernel_tier("cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compat.default_device()
    assert compat.set_kernel_tier("torch") == "torch"
    compat.reset_kernel_tier()
    assert compat.explicit_kernel_tier() is None


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros((1, 2, 4, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(q[:, :, :1], q, q, 0)
    with pytest.raises(ValueError, match="CUDA"):
        rn.subnet_rmsnorm(q, torch.ones((1, 128)),
                          torch.tensor([0], dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        rn.add_subnet_rmsnorm(q, q, torch.ones((1, 128)),
                              torch.tensor([0], dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        sm.sliced_matmul(q[0, 0], q[0, 0].T, None, None)


def test_build_counter_reads_triton_builds_at_its_edges(monkeypatch, tmp_path):
    """Kernel builds are the nvcc compiles of ``build.library`` (one per
    source, started together, here through a stand-in ``nvcc`` that only
    writes its output), read by BuildCounter at the block's edges and never
    by the launch path: a launch adds a launch, not a build."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi; shift\n'
                    'done\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDACXX", str(nvcc))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    reads = []
    edge = compat.builds
    monkeypatch.setattr(compat, "builds", lambda: reads.append(1) or edge())
    with compat.BuildCounter() as bc:
        lib = build._build(tmp_path / "build" / "kernels-test")
        compat.note_launch("subnet_rmsnorm")
    assert lib.is_file() and lib.name == build.LIB_NAME
    assert [p.name for p in build.sources()].count("subnet_rmsnorm.cu") == 1
    assert bc.count == len(build.sources()) and len(reads) == 2
    with compat.BuildCounter() as bc:
        for _ in range(3):
            compat.note_launch("subnet_rmsnorm")
    assert bc.count == 0 and len(reads) == 4


def test_decode_split_plan_covers_the_cache():
    """The grid's splits, sized from static facts, hold every live split
    of a full cache, and the live splits' chunks cover it exactly."""
    for sms in (114, 132):
        for bkv in (1, 2, 16, 128, 1000):
            for smax in (16, 64, 96, 256, 4096):
                n = da.grid_splits(bkv, smax, sms)
                chunk, n_live = da.schedule(smax, n, da.PLAN.min_chunk)
                assert 1 <= n_live <= n and chunk >= 1
                assert n_live * chunk >= smax > (n_live - 1) * chunk
