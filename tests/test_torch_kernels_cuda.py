"""The hand-written kernels of the PyTorch port against their plain
versions, on the card, at main-path shapes in bf16 (tolerance 2e-2, the
bf16 tolerance of tests/test_kernels.py). Every test skips without a CUDA
device. This file imports neither JAX nor the JAX package, so it runs on a
GPU machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import sliced_matmul as sm
from repro_torch.kernels import subnet_rmsnorm as rn

TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# on the card: each kernel against its plain version at main-path shapes
# --------------------------------------------------------------------------


def _randn(gen, *shape, dev, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


# (S, window, kv_len): ragged prompts around the 64-row tile and the 64-key
# tile, a window with a short kv_len, the served S = 16 and S = 256
FLASH_CASES = [(1, 0, None), (16, 0, None), (63, 0, None), (64, 0, None),
               (65, 0, 40), (200, 64, 150), (256, 0, None)]


@pytest.mark.parametrize("head_width", [None, 6, 12])
@pytest.mark.parametrize("layout", ["bhsd", "bshd-view"])
@pytest.mark.parametrize("S,window,kv_len", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, S, window, kv_len, layout,
                                              head_width):
    """qwen2-1.5b heads (12 over 2 kv heads): against the plain version,
    with kv_len and the head width (each qwen2-1.5b bucket; 6 as a device
    tensor, as switch mode passes it) read on the card, on contiguous
    (B, H, S, d) tensors and on (B, S, H, d) buffers viewed as the model
    passes them; two launches give the same bits, inactive heads are 0."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    if layout == "bhsd":
        q = _randn(gen, 2, 12, S, 128, dev=cuda)
        k = _randn(gen, 2, 2, S, 128, dev=cuda)
        v = _randn(gen, 2, 2, S, 128, dev=cuda)
    else:   # one (B, S, 16, d) projection, split as views
        qkv = _randn(gen, 2, S, 16, 128, dev=cuda)
        q, k, v = (t.transpose(1, 2) for t in qkv.split([12, 2, 2], dim=2))
    kvl = None if kv_len is None else _i32(kv_len, cuda)
    hw = _i32(head_width, cuda) if head_width == 6 else head_width
    got = fa.flash_attention(q, k, v, window=window, kv_len=kvl,
                             head_width=hw)
    want = fa.flash_attention_plain(q, k, v, window=window, kv_len=kvl,
                                    head_width=hw)
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    assert torch.equal(got, fa.flash_attention(q, k, v, window=window,
                                               kv_len=kvl, head_width=hw))
    if head_width is not None:
        idle = ~ref.head_active(12, 2, head_width, cuda)
        assert idle.sum() == 12 - head_width
        assert (got[:, idle] == 0).all()


# the heads of each head dim the kernels are built for: stablelm-3b's MHA
# at d = 80 (G = 1), h2o-danube-3-4b's G = 4 at d = 120, qwen2.5-14b's G = 5
# at d = 128, with 2 kv heads (8 under MHA) to keep the cases small
HEAD_DIM_HEADS = {64: (8, 8), 80: (8, 8), 120: (8, 2), 128: (10, 2)}
GUARD = 64          # elements past an output, which no launch may write


def _guarded(shape, cuda):
    """A bf16 buffer of ``shape`` followed by GUARD elements, all 7.0:
    (the output view, the guard view)."""
    n = 1
    for s in shape:
        n *= s
    buf = torch.full((n + GUARD,), 7.0, dtype=torch.bfloat16, device=cuda)
    return buf[:n].view(shape), buf[n:]


def _flash_into(o, q, k, v, *, window=0, kv_len=None, head_width=None):
    """One launch of the flash kernel's C entry point writing into ``o``, a
    contiguous (B, Sq, Hq, d) buffer, with the wrapper's plan."""
    B, Hq, Sq, d = q.shape
    kvl = (None, k.shape[2]) if kv_len is None else (kv_len.data_ptr(), 0)
    hw = ((None, -1) if head_width is None
          else (head_width.data_ptr(), 0)
          if isinstance(head_width, torch.Tensor) else (None, head_width))
    fn = build.function(fa._C, fa._ARGTYPES)
    build.check(fa.NAME, fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, Hq, k.shape[1], Sq, k.shape[2], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], 1, int(window),
        *kvl, *hw, fa.pack_plan(Sq, Hq // k.shape[1]).word,
        torch.cuda.current_stream(q.device).cuda_stream))


@pytest.mark.parametrize("layout", ["bhsd", "bshd-view"])
@pytest.mark.parametrize("S,window,kv_len", FLASH_CASES)
@pytest.mark.parametrize("d", [64, 80, 120])
def test_flash_attention_kernel_matches_plain_at_head_dims(cuda, d, S, window,
                                                           kv_len, layout):
    """d = 64 (MHA, musicgen-medium's heads; the second 64-column box lies
    wholly past d), d = 80 (MHA, stablelm-3b's) and d = 120 (G = 4,
    h2o-danube's) over the cases of d = 128: against the plain version at
    every head width (half of them as a device tensor), two launches
    bitwise equal, inactive heads exactly 0, and nothing written past the
    output's d columns (the guard after it keeps its value)."""
    _flash_at_heads(cuda, d, *HEAD_DIM_HEADS[d], S, window, kv_len, layout)


@pytest.mark.parametrize("layout", ["bhsd", "bshd-view"])
@pytest.mark.parametrize("S,window,kv_len", FLASH_CASES)
def test_flash_attention_kernel_matches_plain_at_group_7(cuda, S, window,
                                                         kv_len, layout):
    """qwen2-vl-7b's heads, 28 over 4 kv heads (G = 7: one head a block),
    d = 128, as the other head dims are checked."""
    _flash_at_heads(cuda, 128, 28, 4, S, window, kv_len, layout)


def _flash_at_heads(cuda, d, Hq, Hkv, S, window, kv_len, layout):
    gen = torch.Generator(device=cuda).manual_seed(S + d)
    if layout == "bhsd":
        q = _randn(gen, 2, Hq, S, d, dev=cuda)
        k = _randn(gen, 2, Hkv, S, d, dev=cuda)
        v = _randn(gen, 2, Hkv, S, d, dev=cuda)
    else:
        qkv = _randn(gen, 2, S, Hq + 2 * Hkv, d, dev=cuda)
        q, k, v = (t.transpose(1, 2)
                   for t in qkv.split([Hq, Hkv, Hkv], dim=2))
    kvl = None if kv_len is None else _i32(kv_len, cuda)
    for head_width in (None, _i32(Hq // 2, cuda), Hq):
        kw = dict(window=window, kv_len=kvl, head_width=head_width)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(got.float(), want.float(), **TOL)
        assert torch.equal(got, fa.flash_attention(q, k, v, **kw))
        if head_width is not None:
            idle = ~ref.head_active(Hq, Hkv, head_width, cuda)
            assert (got[:, idle] == 0).all()
        o, guard = _guarded((2, S, Hq, d), cuda)
        _flash_into(o, q, k, v, **kw)
        torch.cuda.synchronize()
        assert torch.equal(o.transpose(1, 2), got)
        assert (guard == 7.0).all()


def test_flash_attention_kernel_takes_no_stale_map(cuda):
    """d = 128 and then d = 80, 120 and 64 on the same storage with the
    same strides (the narrower tensors are views of the first d columns):
    the tensor maps are keyed by d, so each call reads rows d wide, and
    each call matches the plain version on its own tensors."""
    gen = torch.Generator(device=cuda).manual_seed(21)
    q = _randn(gen, 2, 10, 64, 128, dev=cuda)
    k = _randn(gen, 2, 2, 64, 128, dev=cuda)
    v = _randn(gen, 2, 2, 64, 128, dev=cuda)
    for dd in (128, 80, 128, 120, 64):
        qd, kd, vd = q[..., :dd], k[..., :dd], v[..., :dd]
        got = fa.flash_attention(qd, kd, vd)
        want = fa.flash_attention_plain(qd.contiguous(), kd.contiguous(),
                                        vd.contiguous())
        assert got.shape == (2, 10, 64, dd)
        torch.testing.assert_close(got.float(), want.float(), **TOL)


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    """The wrappers raise, before any launch, on a head_dim they were not
    built for (flash and decode), rows that are not 16-byte aligned, a
    kv_len tensor of another type and a negative head width."""
    q = torch.zeros((1, 12, 16, 128), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 2, 16, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q[..., :96], k[..., :96], k[..., :96])
    assert fa.HEAD_DIMS == da.HEAD_DIMS == (64, 80, 120, 128)
    for d in (32, 96):
        qd = q[..., :d].contiguous()
        kd = k[..., :d].contiguous()
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention(qd, kd, kd)
        with pytest.raises(ValueError, match="head_dim"):
            da.decode_attention(qd[:, :, :1].contiguous(), kd, kd, 0)
    buf = torch.zeros(q.numel() + 4, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(buf[4:].view(q.shape), k, k)   # 8-byte offset
    with pytest.raises(TypeError, match="kv_len"):
        fa.flash_attention(q, k, k, kv_len=torch.tensor(
            16, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="head_width"):
        fa.flash_attention(q, k, k, head_width=-1)


def test_flash_attention_q_offset_on_cuda_raises(cuda):
    from repro_torch.kernels import ops
    q = torch.zeros((1, 12, 16, 128), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 2, 16, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError, match="q_offset / scale"):
        ops.model_flash_attention(q, k, k, q_offset=1)


@pytest.mark.parametrize("Smax", [16, 32, 100, 256, 2048])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("G", [1, 5, 6, 8])
def test_decode_attention_kernel_matches_plain(cuda, G, B, Smax):
    """G query heads over 2 kv heads (qwen2-1.5b: G = 6), every index
    class and a window, against the plain version, on caches of the
    served buckets, a ragged one (100: a last unit of 4 positions, a
    window that wraps) and a long one; two launches give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = _randn(gen, B, 2 * G, 1, 128, dev=cuda)
    kc = _randn(gen, B, 2, Smax, 128, dev=cuda)
    vc = _randn(gen, B, 2, Smax, 128, dev=cuda)
    for index in sorted({0, 3, Smax // 2, Smax - 1}):
        idx = torch.tensor(index, dtype=torch.int32, device=cuda)
        for window in (0, 64):
            got = da.decode_attention(q, kc, vc, idx, window=window)
            want = da.decode_attention_plain(q, kc, vc, idx, window=window)
            torch.testing.assert_close(got.float(), want.float(), **TOL)
            assert torch.equal(got, da.decode_attention(q, kc, vc, idx,
                                                        window=window))


@pytest.mark.parametrize("Smax", [16, 100, 256, 2048])
@pytest.mark.parametrize("G", [1, 4, 5, 7])
@pytest.mark.parametrize("d", [64, 80, 120, 128])
def test_decode_attention_kernel_matches_plain_at_head_dims(cuda, d, G, Smax):
    """d = 64, 80, 120 and 128 with G = 1 (stablelm-3b, musicgen-medium), 4
    (h2o-danube-3-4b), 5 (qwen2.5-14b) and 7 (qwen2-vl-7b) over 2 kv
    heads, B = 8, every index class, window 0 and
    64: against the plain version, two launches bitwise equal, and nothing
    written past the output's d columns (the guard after it keeps its
    value), with one live split and with a row's splits merged."""
    gen = torch.Generator(device=cuda).manual_seed(d + G)
    q = _randn(gen, 8, 2 * G, 1, d, dev=cuda)
    kc = _randn(gen, 8, 2, Smax, d, dev=cuda)
    vc = _randn(gen, 8, 2, Smax, d, dev=cuda)
    for index in sorted({0, 3, Smax // 2, Smax - 1}):
        idx = torch.tensor(index, dtype=torch.int32, device=cuda)
        for window in (0, 64):
            got = da.decode_attention(q, kc, vc, idx, window=window)
            want = da.decode_attention_plain(q, kc, vc, idx, window=window)
            torch.testing.assert_close(got.float(), want.float(), **TOL)
            assert torch.equal(got, da.decode_attention(q, kc, vc, idx,
                                                        window=window))
            out, guard = _guarded(q.shape, cuda)
            build.check(da.NAME, da._launch(q, kc, vc, idx, out, window,
                                            da.PLAN))
            torch.cuda.synchronize()
            assert torch.equal(out, got)
            assert (guard == 7.0).all()


def test_decode_attention_is_one_kernel_per_call(cuda):
    """One device kernel a call, with one live split and with many."""
    from torch.profiler import ProfilerActivity, profile
    q = torch.ones((8, 12, 1, 128), dtype=torch.bfloat16, device=cuda)
    for Smax, index in ((16, 3), (256, 255), (2048, 1023)):
        kc = torch.ones((8, 2, Smax, 128), dtype=torch.bfloat16, device=cuda)
        idx = torch.tensor(index, dtype=torch.int32, device=cuda)
        da.decode_attention(q, kc, kc, idx)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                da.decode_attention(q, kc, kc, idx)
            torch.cuda.synchronize()
        names = [ev.name for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 3, names
        assert all("decode_attention_kernel" in n for n in names), names


def test_decode_attention_allocates_only_its_output(cuda):
    """A call allocates its output and nothing else, with one live split
    (the served decode: one block a row writes it) and with many (merged
    inside each row's cluster)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = _randn(gen, 8, 12, 1, 128, dev=cuda)
    for Smax, index, merged in ((64, 63, False), (2048, 2047, True)):
        kc = _randn(gen, 8, 2, Smax, 128, dev=cuda)
        vc = _randn(gen, 8, 2, Smax, 128, dev=cuda)
        idx = torch.tensor(index, dtype=torch.int32, device=cuda)
        n_split = da.grid_splits(16, Smax, da._sm_count(q.device))
        _, length = da.live_range(index, 0, Smax)
        n_live = da.schedule(length, n_split, da.PLAN.min_chunk)[1]
        assert (n_live > 1) == merged
        want = da.decode_attention_plain(q, kc, vc, idx)
        da.decode_attention(q, kc, vc, idx)            # built and bound
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(cuda)
        got = da.decode_attention(q, kc, vc, idx)
        assert torch.cuda.memory_allocated(cuda) - before \
            == got.untyped_storage().nbytes()
        torch.testing.assert_close(got.float(), want.float(), **TOL)
        del got


def test_decode_attention_kernel_refuses_a_split_past_a_cluster(cuda):
    """The entry point refuses more splits than a cluster holds, a plan it
    was not built for and a head_dim it was not built for, before anything
    runs."""
    q = torch.ones((8, 12, 1, 128), dtype=torch.bfloat16, device=cuda)
    kc = torch.ones((8, 2, 256, 128), dtype=torch.bfloat16, device=cuda)
    idx = torch.tensor(255, dtype=torch.int32, device=cuda)
    out = torch.full_like(q, 7.0)
    fn = build.function(da._C, da._ARGTYPES)
    stream = torch.cuda.current_stream(cuda).cuda_stream

    def call(n_split, plan, head_dim=128):
        return fn(q.data_ptr(), kc.data_ptr(), kc.data_ptr(), idx.data_ptr(),
                  out.data_ptr(), 8, 2, 6, 256, head_dim, 0, n_split, plan,
                  stream)
    assert call(da.MAX_SPLIT + 1, da.PLAN.word) != 0
    assert call(4, da.Plan(64, 4).word) != 0
    assert call(4, da.Plan(24, 2).word) != 0
    assert call(4, da.PLAN.word, head_dim=32) != 0
    assert call(4, da.PLAN.word, head_dim=96) != 0
    torch.cuda.synchronize()
    assert (out == 7.0).all()
    assert call(4, da.PLAN.word) == 0
    torch.testing.assert_close(out.float(), torch.ones_like(out.float()))


NORM_DTYPES = [torch.bfloat16, torch.float32]


def _norm_inputs(cuda, rows, d, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = _randn(gen, rows, d, dev=cuda, dtype=dtype)
    delta = _randn(gen, rows, d, dev=cuda, dtype=dtype)
    gamma = 1 + 0.1 * _randn(gen, 18, d, dev=cuda, dtype=torch.float32)
    return x, delta, gamma


@pytest.mark.parametrize("dtype", NORM_DTYPES)
@pytest.mark.parametrize("d", [64, 1536, 5120, 8200])
@pytest.mark.parametrize("rows", [1, 8, 128, 129, 2048])
def test_subnet_rmsnorm_kernel_matches_plain(cuda, rows, d, dtype):
    """The standalone form at decode (8), prefill (128, 2048) and ragged
    row counts, at qwen2-1.5b's width, qwen2.5-14b's, a narrow one and one
    past the register buckets (fp32 at 8200 takes the streaming variant):
    against the plain version for the first and last subnet, two launches
    bitwise equal."""
    x, _, gamma = _norm_inputs(cuda, rows, d, dtype, rows + d)
    for sid in (0, 17):
        s = _i32(sid, cuda)
        got = rn.subnet_rmsnorm(x, gamma, s)
        assert got.shape == x.shape and got.dtype == dtype
        torch.testing.assert_close(
            got.float(), rn.subnet_rmsnorm_plain(x, gamma, s).float(), **TOL)
        assert torch.equal(got, rn.subnet_rmsnorm(x, gamma, s))


@pytest.mark.parametrize("dtype", NORM_DTYPES)
@pytest.mark.parametrize("d", [64, 1536, 5120, 8200])
@pytest.mark.parametrize("rows", [1, 8, 128, 129, 2048])
def test_add_subnet_rmsnorm_kernel_matches_plain(cuda, rows, d, dtype):
    """The fused form: s equals ``x + delta`` (torch.add on the card) bit
    for bit, h is within TOL of the plain version's norm of s, and two
    launches give the same bits."""
    x, delta, gamma = _norm_inputs(cuda, rows, d, dtype, rows * d)
    for sid in (0, 17):
        sidt = _i32(sid, cuda)
        s, h = rn.add_subnet_rmsnorm(x, delta, gamma, sidt)
        assert s.shape == h.shape == x.shape and s.dtype == h.dtype == dtype
        assert torch.equal(s, x + delta)
        want_s, want_h = rn.add_subnet_rmsnorm_plain(x, delta, gamma, sidt)
        assert torch.equal(s, want_s)
        torch.testing.assert_close(h.float(), want_h.float(), **TOL)
        s2, h2 = rn.add_subnet_rmsnorm(x, delta, gamma, sidt)
        assert torch.equal(s, s2) and torch.equal(h, h2)


def test_subnet_rmsnorm_reads_subnet_id_on_the_card(cuda):
    """Rewriting subnet_id in device memory between launches picks the new
    gain row in both forms, with no build."""
    from repro_torch import compat
    x, delta, gamma = _norm_inputs(cuda, 128, 1536, torch.bfloat16, 7)
    sid = _i32(0, cuda)
    rn.add_subnet_rmsnorm(x, delta, gamma, sid)
    rn.subnet_rmsnorm(x, gamma, sid)
    with compat.BuildCounter() as bc:
        for v in (5, 17, 0):
            sid.fill_(v)
            want = rn.subnet_rmsnorm_plain(x, gamma, _i32(v, cuda))
            torch.testing.assert_close(rn.subnet_rmsnorm(x, gamma, sid).float(),
                                       want.float(), **TOL)
            _, h = rn.add_subnet_rmsnorm(x, delta, gamma, sid)
            _, want = rn.add_subnet_rmsnorm_plain(x, delta, gamma,
                                                  _i32(v, cuda))
            torch.testing.assert_close(h.float(), want.float(), **TOL)
    assert bc.count == 0


def test_subnet_rmsnorm_is_one_kernel_and_one_allocation_per_call(cuda):
    """Each form is one device kernel a call and allocates its output and
    nothing else (one ``(2, rows, d)`` buffer for the fused form)."""
    from torch.profiler import ProfilerActivity, profile
    x, delta, gamma = _norm_inputs(cuda, 128, 1536, torch.bfloat16, 8)
    sid = _i32(3, cuda)
    for fn in (lambda: rn.subnet_rmsnorm(x, gamma, sid),
               lambda: rn.add_subnet_rmsnorm(x, delta, gamma, sid)):
        fn()
        torch.cuda.synchronize()
        for _ in range(3):        # a trace that lost events is taken again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
            names = [ev.name for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA]
            assert len(names) <= 3, names
            if len(names) == 3:
                break
        assert len(names) == 3, names
        assert all("subnet_rmsnorm_kernel" in n for n in names), names
        before = torch.cuda.memory_allocated(cuda)
        out = fn()
        first = out[0] if isinstance(out, tuple) else out
        assert torch.cuda.memory_allocated(cuda) - before \
            == first.untyped_storage().nbytes()
        if isinstance(out, tuple):
            assert out[1].untyped_storage().data_ptr() \
                == first.untyped_storage().data_ptr()
        del out, first


def test_subnet_rmsnorm_kernel_refuses_what_it_does_not_take(cuda):
    """Rows that are not 16-byte aligned, a width that is not a multiple
    of 8, a delta of another shape and a subnet_id of another type raise
    before any launch; the C entry point refuses a width that is not a
    multiple of 8."""
    x, delta, gamma = _norm_inputs(cuda, 8, 1536, torch.bfloat16, 9)
    sid = _i32(0, cuda)
    buf = torch.zeros(x.numel() + 4, dtype=x.dtype, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        rn.subnet_rmsnorm(buf[4:].view(x.shape), gamma, sid)  # 8 bytes off
    with pytest.raises(ValueError, match="aligned"):
        rn.add_subnet_rmsnorm(x, buf[4:].view(x.shape), gamma, sid)
    with pytest.raises(ValueError, match="multiple of 8"):
        rn.subnet_rmsnorm(x[:, :100].contiguous(), gamma[:, :100].contiguous(),
                          sid)
    with pytest.raises(ValueError, match="delta"):
        rn.add_subnet_rmsnorm(x, delta[:4], gamma, sid)
    with pytest.raises(TypeError, match="subnet_id"):
        rn.subnet_rmsnorm(x, gamma, sid.long())
    out = torch.full_like(x, 7.0)
    fn = build.function(rn._C[torch.bfloat16], rn._ARGTYPES)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert fn(x.data_ptr(), None, gamma.data_ptr(), sid.data_ptr(),
              out.data_ptr(), 8, 1532, 1e-5, stream) != 0
    torch.cuda.synchronize()
    assert (out == 7.0).all()


def _i32(v, dev):
    return torch.tensor(v, dtype=torch.int32, device=dev)


def test_sliced_matmul_kernel_matches_plain(cuda):
    """Main-path shapes, partial K and N tiles, rows past M, widths as
    ints and read from device memory; columns past active_out are 0."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    cases = [(128, 1536, 8960, None, 4480), (8, 1536, 8960, None, 6656),
             (128, 8960, 1536, 4480, None), (8, 8960, 1536, 8960, None),
             (7, 256, 192, 200, 100), (65, 264, 136, 9, 1), (3, 64, 64, 0, 64),
             (5, 128, 256, 128, 0)]
    for M, K, N, ai, ao in cases:
        x, w = _randn(gen, M, K, dev=cuda), _randn(gen, K, N, dev=cuda)
        want = sm.sliced_matmul_plain(x, w, ai, ao)
        for a, b in ((ai, ao), (None if ai is None else _i32(ai, cuda),
                                None if ao is None else _i32(ao, cuda))):
            got = sm.sliced_matmul(x, w, a, b)
            torch.testing.assert_close(got.float(), want.float(), **TOL)
            if ao is not None:
                assert not got[:, ao:].any()


def test_sliced_matmul_kernel_takes_strided_segments(cuda):
    """The GQA output projection: a (B*S, Hq*hd) view with a row stride of
    its own, in 2 segments with 3 of 6 heads each, and per-group views."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    buf = _randn(gen, 16, 2 * 1536 + 64, dev=cuda)
    o = buf[:, 64:64 + 1536]                       # row stride 3136
    wo = _randn(gen, 1536, 1536, dev=cuda)
    for heads in (3, 6):
        act = _i32(heads * 128, cuda)
        got = sm.sliced_matmul(o, wo, act, None, segments=2)
        want = sm.sliced_matmul_plain(o, wo, act, None, segments=2)
        torch.testing.assert_close(got.float(), want.float(), **TOL)
        for g in range(2):                         # one group's views
            og, wg = o[:, g * 768:(g + 1) * 768], wo[g * 768:(g + 1) * 768]
            torch.testing.assert_close(
                sm.sliced_matmul(og, wg, act, None).float(),
                sm.sliced_matmul_plain(og, wg, act, None).float(), **TOL)


# the switch path's projections of the three dense configs beside
# qwen2-1.5b: wo in segments of 480 (h2o-danube-3-4b, 8 kv groups of 4
# heads of 120), 640 (qwen2.5-14b, 8 groups of 5 heads of 128) and one of
# 2560 (stablelm-3b, MHA), at the full and the half head width; the FFN at
# each config's d_ff and its narrowest width
CONFIG_PROJECTIONS = [
    ("danube wo", 3840, 3840, 480, 8), ("danube wo", 3840, 3840, 240, 8),
    ("14b wo", 5120, 5120, 640, 8), ("14b wo", 5120, 5120, 256, 8),
    ("stablelm wo", 2560, 2560, 2560, 1), ("stablelm wo", 2560, 2560, 1280, 1),
    ("danube down", 10240, 3840, 5120, 1), ("14b down", 13824, 5120, 6912, 1),
    ("stablelm down", 6912, 2560, 3456, 1)]


@pytest.mark.parametrize("M", [8, 128])
@pytest.mark.parametrize("label,K,N,ai,nseg", CONFIG_PROJECTIONS)
def test_sliced_matmul_kernel_at_config_projections(cuda, label, K, N, ai,
                                                    nseg, M):
    """Segments that are not a multiple of the kernel's 64-deep K step (480
    is 7.5 steps, so a step reads the next segment's first rows, which the
    kernel zeroes), against the plain version, two launches bitwise
    equal; and the FFN up projection to those widths, zero past them."""
    gen = torch.Generator(device=cuda).manual_seed(K + ai + M)
    x, w = _randn(gen, M, K, dev=cuda), _randn(gen, K, N, dev=cuda)
    a = _i32(ai, cuda)
    got = sm.sliced_matmul(x, w, a, None, segments=nseg)
    torch.testing.assert_close(
        got.float(),
        sm.sliced_matmul_plain(x, w, a, None, segments=nseg).float(), **TOL)
    assert torch.equal(got, sm.sliced_matmul(x, w, a, None, segments=nseg))
    if nseg == 1 and label.endswith("down"):
        xu, wu = _randn(gen, M, N, dev=cuda), _randn(gen, N, K, dev=cuda)
        up = sm.sliced_matmul(xu, wu, None, a)
        torch.testing.assert_close(
            up.float(), sm.sliced_matmul_plain(xu, wu, None, a).float(),
            **TOL)
        assert not up[:, ai:].any()


def test_sliced_matmul_kernel_over_row_counts(cuda):
    """Every row count the schedule treats apart: one block tile of 64 rows
    or more, a ragged last tile, and a prefill of 2048 rows, at FFN widths
    cut to a narrow subnet."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    for M in (1, 7, 8, 64, 128, 129, 2048):
        for K, N, ai, ao in ((1536, 8960, None, 4480),
                             (8960, 1536, 6656, None)):
            x, w = _randn(gen, M, K, dev=cuda), _randn(gen, K, N, dev=cuda)
            a = None if ai is None else _i32(ai, cuda)
            b = None if ao is None else _i32(ao, cuda)
            got = sm.sliced_matmul(x, w, a, b)
            torch.testing.assert_close(
                got.float(), sm.sliced_matmul_plain(x, w, a, b).float(), **TOL)
            if ao is not None:
                assert not got[:, ao:].any()


def test_sliced_matmul_kernel_repeats_its_bits(cuda):
    """The same widths give the same bits, launch after launch, whatever
    widths the launches between used: sums run in a fixed order."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    for M, K, N, nseg in ((8, 8960, 1536, 1), (128, 1536, 8960, 1),
                          (128, 1536, 1536, 2)):
        x, w = _randn(gen, M, K, dev=cuda), _randn(gen, K, N, dev=cuda)
        ai, ao = _i32(K // nseg, cuda), _i32(N, cuda)
        first = sm.sliced_matmul(x, w, ai, ao, segments=nseg)
        for width in (K // nseg // 2, 40, K // nseg):
            ai.fill_(width)
            ao.fill_(N // 2 if width != K // nseg else N)
            sm.sliced_matmul(x, w, ai, ao, segments=nseg)
        again = sm.sliced_matmul(x, w, ai, ao, segments=nseg)
        assert torch.equal(first, again)


def test_sliced_matmul_kernel_splits_segments(cuda):
    """Segments whose live K tiles are shared among several splits of one
    output tile: few live tiles (N = 128) against long segments."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = _randn(gen, 16, 4 * 2048, dev=cuda)
    w = _randn(gen, 4 * 2048, 128, dev=cuda)
    plan = sm.split_plan(16, 128, 4 * 2048, 4, 1000, None,
                         sm.grid_size(cuda))
    assert plan.splits > 1
    for ai in (2048, 1000, 64, 1):
        a = _i32(ai, cuda)
        torch.testing.assert_close(
            sm.sliced_matmul(x, w, a, None, segments=4).float(),
            sm.sliced_matmul_plain(x, w, a, None, segments=4).float(), **TOL)


def test_sliced_matmul_kernel_refuses_short_scratch(cuda):
    """The kernel decides its scratch: the size it reports covers the
    plan's units and counters, and a launch handed less is refused before
    anything runs."""
    grid = sm.grid_size(cuda)
    x = torch.ones((128, 1536), dtype=torch.bfloat16, device=cuda)
    w = torch.ones((1536, 1536), dtype=torch.bfloat16, device=cuda)
    for M in (1, 128, 129, 2048):
        for bn in (sm.BN, sm.BN_WIDE):
            if bn == sm.BN_WIDE and sm.block_rows(M) < 128:
                with pytest.raises(RuntimeError):     # no 64 x 256 tile
                    sm._workspace_size(M, bn, grid)
                continue
            elems, counters = sm._workspace_size(M, bn, grid)
            assert elems >= sm.WORKSPACE_TILES * grid * sm.block_rows(M) * bn
            assert counters >= bn // sm.BN * grid   # one a 128-column half
    elems, counters = sm._workspace_size(128, sm.BN, grid)
    y = torch.full((128, 1536), 7.0, dtype=torch.bfloat16, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for n_part, n_count in ((elems - 1, counters), (elems, counters - 1)):
        part = torch.empty(n_part, dtype=torch.float32, device=cuda)
        cnt = torch.zeros(n_count, dtype=torch.int32, device=cuda)
        assert sm._launch(x, w, y, 1, None, 1536, None, 1536, part, cnt,
                          grid, stream, sm.BN) != 0
    torch.cuda.synchronize()
    assert (y == 7.0).all()
    part = torch.empty(elems, dtype=torch.float32, device=cuda)
    cnt = torch.zeros(counters, dtype=torch.int32, device=cuda)
    assert sm._launch(x, w, y, 1, None, 1536, None, 1536, part, cnt,
                      grid, stream, sm.BN) == 0
    torch.testing.assert_close(y.float(), torch.full_like(y.float(), 1536.0))


# stacks of experts, (E, C, K, N, active_in, active_out): mixtral's gate/up
# and down at a decode step and a prefill, llama4's at a decode step, at
# the half width; few experts with ragged tiles (K splits); no live column
GROUPED_CASES = [(8, 8, 4096, 14336, None, 7168), (8, 8, 14336, 4096, 7168, None),
                 (8, 40, 4096, 14336, None, 10752),
                 (128, 8, 5120, 8192, None, 4096), (128, 8, 8192, 5120, 4096, None),
                 (3, 7, 264, 136, 9, 1), (2, 65, 128, 256, 128, 0)]


@pytest.mark.parametrize("E,C,K,N,ai,ao", GROUPED_CASES)
def test_grouped_sliced_matmul_matches_plain(cuda, E, C, K, N, ai, ao):
    """One launch for all experts against the plain version, columns past
    active_out exactly 0, two launches bitwise equal, one device kernel."""
    gen = torch.Generator(device=cuda).manual_seed(E + C + K)
    x, w = _randn(gen, E, C, K, dev=cuda), _randn(gen, E, K, N, dev=cuda)
    a = None if ai is None else _i32(ai, cuda)
    b = None if ao is None else _i32(ao, cuda)
    got = sm.sliced_matmul(x, w, a, b)
    assert got.shape == (E, C, N)
    torch.testing.assert_close(
        got.float(), sm.sliced_matmul_plain(x, w, a, b).float(), **TOL)
    if ao is not None:
        assert not got[..., ao:].any()
    assert torch.equal(got, sm.sliced_matmul(x, w, a, b))
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sm.sliced_matmul(x, w, a, b)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "sliced_matmul_kernel" in kernels[0]


def test_grouped_sliced_matmul_of_one_expert_is_the_2d_kernel(cuda):
    """A stack of one gives the 2-d kernel's bits, whatever the widths."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    for M, K, N, ai, ao in ((8, 4096, 14336, None, 7168),
                            (128, 1536, 1536, 384, None), (7, 264, 136, 9, 1)):
        x, w = _randn(gen, M, K, dev=cuda), _randn(gen, K, N, dev=cuda)
        a = None if ai is None else _i32(ai, cuda)
        b = None if ao is None else _i32(ao, cuda)
        assert torch.equal(sm.sliced_matmul(x[None], w[None], a, b)[0],
                           sm.sliced_matmul(x, w, a, b))


def test_grouped_sliced_matmul_repeats_its_bits(cuda):
    """The same widths give the same bits, launch after launch, whatever
    widths the launches between used."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    x, w = _randn(gen, 8, 40, 4096, dev=cuda), _randn(gen, 8, 4096, 1024,
                                                      dev=cuda)
    ao = _i32(1024, cuda)
    first = sm.sliced_matmul(x, w, None, ao)
    for width in (512, 8, 1024):
        ao.fill_(width)
        sm.sliced_matmul(x, w, None, ao)
    assert torch.equal(first, sm.sliced_matmul(x, w, None, ao))


def test_grouped_sliced_matmul_refuses_short_scratch(cuda):
    """A stack's launch takes the scratch of its row count, as a 2-d one
    does, and is refused with less, before anything runs."""
    grid = sm.grid_size(cuda)
    x = torch.ones((8, 8, 512), dtype=torch.bfloat16, device=cuda)
    w = torch.ones((8, 512, 256), dtype=torch.bfloat16, device=cuda)
    elems, counters = sm._workspace_size(8, sm.BN, grid)
    y = torch.full((8, 8, 256), 7.0, dtype=torch.bfloat16, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for n_part, n_count in ((elems - 1, counters), (elems, counters - 1)):
        part = torch.empty(n_part, dtype=torch.float32, device=cuda)
        cnt = torch.zeros(n_count, dtype=torch.int32, device=cuda)
        assert sm._launch(x, w, y, 1, None, 512, None, 256, part, cnt,
                          grid, stream, sm.BN) != 0
    torch.cuda.synchronize()
    assert (y == 7.0).all()
    part = torch.empty(elems, dtype=torch.float32, device=cuda)
    cnt = torch.zeros(counters, dtype=torch.int32, device=cuda)
    assert sm._launch(x, w, y, 1, None, 512, None, 256, part, cnt,
                      grid, stream, sm.BN) == 0
    torch.testing.assert_close(y.float(), torch.full_like(y.float(), 512.0))


# the 128 x 256 block tile, forced whatever block_cols picks: (M, K, N,
# active_in, active_out) at qwen2-1.5b's FFN up and down with active_in
# not a multiple of 64 and active_out not a multiple of 256, and ragged
# shapes whose last column tile reaches past N (TMA boxes wholly outside
# w load zeros)
WIDE_CASES = [(M, K, N, ai, ao) for M in (512, 1024, 4096)
              for K, N, ai, ao in ((1536, 8960, 1000, 4480),
                                   (8960, 1536, 6600, 1000))]
WIDE_CASES += [(129, 264, 136, 9, 100), (300, 520, 200, 300, 136),
               (777, 1536, 8960, None, None)]


@pytest.mark.parametrize("M,K,N,ai,ao", WIDE_CASES)
def test_sliced_matmul_wide_tile_matches_plain(cuda, M, K, N, ai, ao):
    """The wide tile against the plain version, widths as ints and read
    from device memory, columns past active_out exactly 0, two launches
    bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    x, w = _randn(gen, M, K, dev=cuda), _randn(gen, K, N, dev=cuda)
    want = sm.sliced_matmul_plain(x, w, ai, ao)
    for a, b in ((ai, ao), (None if ai is None else _i32(ai, cuda),
                            None if ao is None else _i32(ao, cuda))):
        got = sm._sliced_matmul(x, w, a, b, 1, sm.BN_WIDE)
        torch.testing.assert_close(got.float(), want.float(), **TOL)
        if ao is not None:
            assert not got[:, ao:].any()
        assert torch.equal(got, sm._sliced_matmul(x, w, a, b, 1,
                                                  sm.BN_WIDE))


@pytest.mark.parametrize("heads", [6, 3, 1])
def test_sliced_matmul_wide_tile_takes_segments(cuda, heads):
    """qwen2-1.5b's wo in 2 segments of 768 at M = 1024 in the wide tile:
    the first heads * 128 rows of each segment."""
    gen = torch.Generator(device=cuda).manual_seed(10 + heads)
    x, w = _randn(gen, 1024, 1536, dev=cuda), _randn(gen, 1536, 1536,
                                                      dev=cuda)
    a = _i32(heads * 128, cuda)
    got = sm._sliced_matmul(x, w, a, None, 2, sm.BN_WIDE)
    torch.testing.assert_close(
        got.float(),
        sm.sliced_matmul_plain(x, w, a, None, segments=2).float(), **TOL)
    assert torch.equal(got, sm._sliced_matmul(x, w, a, None, 2, sm.BN_WIDE))


@pytest.mark.parametrize("kind", ["up", "down"])
@pytest.mark.parametrize("C", [320, 640])
def test_grouped_sliced_matmul_wide_tile_matches_plain(cuda, C, kind):
    """mixtral-8x7b's stack of 8 experts at the burst capacities in the
    wide tile, at three quarters of the expert width, against the plain
    version; columns past active_out exactly 0; bitwise repeats."""
    gen = torch.Generator(device=cuda).manual_seed(C + len(kind))
    K, N = (4096, 14336) if kind == "up" else (14336, 4096)
    x, w = _randn(gen, 8, C, K, dev=cuda), _randn(gen, 8, K, N, dev=cuda)
    wid = _i32(10752, cuda)
    a, b = (None, wid) if kind == "up" else (wid, None)
    got = sm._sliced_matmul(x, w, a, b, 1, sm.BN_WIDE)
    torch.testing.assert_close(
        got.float(), sm.sliced_matmul_plain(x, w, a, b).float(), **TOL)
    if kind == "up":
        assert not got[..., 10752:].any()
    assert torch.equal(got, sm._sliced_matmul(x, w, a, b, 1, sm.BN_WIDE))


@pytest.mark.parametrize("M,K,N,E,bn", [
    (128, 1536, 8960, 0, 128), (512, 1536, 8960, 0, 128),
    (4096, 1536, 8960, 0, 256), (2048, 8960, 1536, 0, 256),
    (1024, 1536, 1536, 0, 128), (640, 4096, 14336, 8, 256)])
def test_sliced_matmul_picks_its_tile_from_the_shape(cuda, M, K, N, E, bn):
    """The wrapper launches the tile block_cols picks, one kernel a call
    counted once under its launch name, and its bits are those of that
    tile forced."""
    from repro_torch import compat
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=cuda).manual_seed(M + N)
    lead = (E,) if E else ()
    x = _randn(gen, *lead, M, K, dev=cuda)
    w = _randn(gen, *lead, K, N, dev=cuda)
    assert sm.block_cols(M, N, K, 1, max(E, 1), sm.grid_size(cuda)) == bn
    before = dict(compat.launch_counts())
    got = sm.sliced_matmul(x, w, None, None)
    after = compat.launch_counts()
    name = sm.GROUPED if E else sm.NAME
    assert after.get(name, 0) - before.get(name, 0) == 1
    assert torch.equal(got, sm._sliced_matmul(x, w, None, None, 1, bn))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sm.sliced_matmul(x, w, None, None)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sm.block_rows(M)
    assert len(kernels) == 1
    assert f"sliced_matmul_kernel<{rows}, {bn}>" in kernels[0]


def test_sliced_matmul_wide_tile_repeats_its_bits_over_graph_replays(cuda):
    """One CUDA graph of wide-tile launches serves every width: replayed
    with the widths changed between replays, each replay gives the bits
    of an eager launch at those widths, and the first widths' bits come
    back when they do."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    x = _randn(gen, 2048, 1536, dev=cuda)
    wu, wd = _randn(gen, 1536, 8960, dev=cuda), _randn(gen, 8960, 1536,
                                                      dev=cuda)
    width = _i32(8960, cuda)

    def step():
        up = sm._sliced_matmul(x, wu, None, width, 1, sm.BN_WIDE)
        return sm._sliced_matmul(up, wd, width, None, 1, sm.BN_WIDE)
    s = torch.cuda.Stream(cuda)
    s.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(s):
        step()
    s.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        out = step()
    torch.cuda.synchronize()
    first = None
    for wv in (8960, 4480, 1000, 6656, 8960):
        width.fill_(wv)
        g.replay()
        torch.cuda.synchronize()
        eager = step()
        assert torch.equal(out, eager), wv
        if first is None:
            first = out.clone()
    assert torch.equal(out, first)


def test_moe_switch_block_on_card_matches_mask(cuda):
    """A reduced mixtral layer (experts of d_ff 512, bf16 on the card):
    switch mode, through the grouped kernel, against mask mode on the same
    inputs (the same routing: one norm, one fp32 router product), for
    every subnet."""
    from repro_torch.configs import get_config
    from repro_torch.core import operators as ops
    from repro_torch.core import subnet as sn
    from repro_torch.models import moe
    from repro_torch.models.common import stack_init
    cfg = get_config("mixtral-8x7b").reduced().replace(
        moe_d_ff=512, dtype="bfloat16", d_model=256)
    gen = torch.Generator(device=cuda).manual_seed(10)
    p = {k: v[0] for k, v in stack_init(
        lambda: moe.init_moe(cfg, torch.bfloat16, cuda), 1, gen, cuda).items()}
    x = _randn(gen, 2, 16, cfg.d_model, dev=cuda)
    for sub in sn.enumerate_space(cfg):
        ctrl = ops.device_control(sn.make_control(cfg, sub), cuda)
        got = moe.moe_block(p, cfg, x, ctrl, slice_mode="switch").float()
        want = moe.moe_block(p, cfg, x, ctrl, slice_mode="mask").float()
        torch.testing.assert_close(got, want, atol=2e-2 * want.abs().max(),
                                   rtol=2e-2)


def test_switch_prefill_makes_no_host_sync(cuda):
    """A warmed switch-mode forward reads every width on the card: under
    sync-debug "error" any host sync (a width read back, .item(), a copy
    to the host) raises."""
    from repro_torch.models import lm
    from repro_torch.serving.executor import ExecutorConfig, build_executor
    ex = build_executor(_small_cfg(), seed=0, device=cuda,
                        exec_cfg=ExecutorConfig(batch_buckets=(2,),
                                                seq_buckets=(16,),
                                                slice_mode="switch"))
    ex.warmup(batches=(2,), seqs=(16,))
    tok = torch.ones((2, 16), dtype=torch.long, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            for idx in range(ex.n_subnets):
                lm.hidden_states(ex.params, ex.cfg, {"tokens": tok},
                                 ex._ctrl(idx), slice_mode="switch")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# the model and the executor on the card, against the plain path on the CPU
# --------------------------------------------------------------------------


def _small_cfg():
    from repro_torch.configs.base import ArchConfig, ElasticSpec, Stage
    return ArchConfig(
        name="small-h128", family="dense",
        stages=(Stage(("attn", "mlp"), repeat=3),), d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab_size=1000, head_dim=128, qkv_bias=True,
        dtype="bfloat16",
        elastic=ElasticSpec(depth_fracs=(1 / 3, 2 / 3, 1.0),
                            ffn_fracs=(0.5, 1.0), head_fracs=(0.5, 1.0)))


def _small_cfg_at(d):
    """Small twins at the new head dims: stablelm-3b's family at d = 80
    (MHA, layernorm, 25% rotary) and h2o-danube-3-4b's at d = 120 (G = 4,
    a sliding window of 16), bf16 with 3 layers."""
    from repro_torch.configs.base import ArchConfig, ElasticSpec, Stage
    kw = (dict(n_heads=4, n_kv_heads=4, norm="layernorm", rotary_pct=0.25)
          if d == 80 else dict(n_heads=8, n_kv_heads=2, sliding_window=16))
    return ArchConfig(
        name=f"small-h{d}", family="dense",
        stages=(Stage(("attn", "mlp"), repeat=3),), d_model=320, d_ff=512,
        vocab_size=1000, head_dim=d, dtype="bfloat16",
        elastic=ElasticSpec(depth_fracs=(1 / 3, 2 / 3, 1.0),
                            ffn_fracs=(0.5, 1.0), head_fracs=(0.5, 1.0)),
        **kw)


@pytest.mark.parametrize("slice_mode", ["mask", "switch"])
@pytest.mark.parametrize("d", [80, 120])
def test_lm_on_card_matches_cpu_plain_path_at_head_dims(cuda, d, slice_mode):
    """The small twins on the card against the plain fp32 path on the CPU,
    for every subnet: forward logits, and 20 decode steps of the widest
    subnet (past the window of 16 at d = 120, so the rolling cache
    wraps)."""
    import numpy as np
    from repro_torch.core import subnet as sn
    from repro_torch.models import lm
    cfg = _small_cfg_at(d)
    gpu = lm.init_model(cfg, torch.Generator(device=cuda).manual_seed(d),
                        cuda)
    cpu = lm.from_jax_params(_to_numpy(gpu), device="cpu")
    cfg32 = cfg.replace(dtype="float32")
    toks = np.random.default_rng(d).integers(0, cfg.vocab_size, (2, 24))
    with torch.no_grad():
        for sub in sn.enumerate_space(cfg):
            ctrl = sn.make_control(cfg, sub)
            _close_rel(lm.forward(gpu, cfg, {"tokens": toks}, ctrl,
                                  slice_mode=slice_mode),
                       lm.forward(cpu, cfg32, {"tokens": toks}, ctrl))
        cg = lm.init_cache(cfg, 2, 32, device=cuda)
        cc = lm.init_cache(cfg32, 2, 32, device="cpu")
        for i in range(20):
            lg, cg = lm.decode_step(gpu, cfg, toks[:, i:i + 1], ctrl, cg, i,
                                    slice_mode=slice_mode)
            lc, cc = lm.decode_step(cpu, cfg32, toks[:, i:i + 1], ctrl, cc, i)
            _close_rel(lg, lc)


@pytest.mark.parametrize("slice_mode", ["mask", "switch"])
@pytest.mark.parametrize("name", ["musicgen-medium", "qwen2-vl-7b"])
def test_embed_frontend_lm_on_card_matches_cpu_plain_path(cuda, name,
                                                          slice_mode):
    """Small twins of the embed-frontend configs, bf16, 3 layers at their
    published heads: musicgen-medium's (MHA at d = 64, layernorm, GELU,
    sinusoidal positions) and qwen2-vl-7b's (G = 7 at d = 128, M-RoPE).
    On the card against the plain fp32 path on the CPU, for every subnet:
    forward logits from ``embeds`` (qwen2-vl over three distinct position
    streams) and the prefill's last position, then 12
    decode steps on tokens of the widest subnet."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import Stage
    from repro_torch.core import subnet as sn
    from repro_torch.models import lm
    full = get_config(name)
    cfg = full.replace(stages=(Stage(("attn", "mlp"), repeat=3),),
                       d_model=full.n_heads * 32, d_ff=512, vocab_size=1000)
    gpu = lm.init_model(cfg, torch.Generator(device=cuda).manual_seed(3),
                        cuda)
    cpu = lm.from_jax_params(_to_numpy(gpu), device="cpu")
    cfg32 = cfg.replace(dtype="float32")
    rng = np.random.default_rng(3)
    batch = {"embeds": rng.standard_normal((2, 16, cfg.d_model)
                                           ).astype(np.float32)}
    if cfg.mrope_sections:
        i = np.arange(16)
        batch["positions"] = np.broadcast_to(
            np.stack([np.full(16, 2), i // 4, i % 4])[:, None],
            (3, 2, 16)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, (2, 12))
    with torch.no_grad():
        for sub in sn.enumerate_space(cfg):
            ctrl = sn.make_control(cfg, sub)
            want = lm.forward(cpu, cfg32, batch, ctrl)
            _close_rel(lm.forward(gpu, cfg, batch, ctrl,
                                  slice_mode=slice_mode), want)
            # the last position alone, through the norm kernel's rows
            _close_rel(lm.prefill(gpu, cfg, batch, ctrl,
                                  slice_mode=slice_mode), want[:, -1:])
        cg = lm.init_cache(cfg, 2, 16, device=cuda)
        cc = lm.init_cache(cfg32, 2, 16, device="cpu")
        for i in range(12):
            lg, cg = lm.decode_step(gpu, cfg, toks[:, i:i + 1], ctrl, cg, i,
                                    slice_mode=slice_mode)
            lc, cc = lm.decode_step(cpu, cfg32, toks[:, i:i + 1], ctrl, cc, i)
            _close_rel(lg, lc)


def _close_rel(got, want):
    scale = want.abs().max().item()
    torch.testing.assert_close(got.float().cpu(), want, rtol=2e-2,
                               atol=2e-2 * scale)


def test_lm_on_card_matches_cpu_plain_path_for_every_subnet(cuda):
    import numpy as np
    from repro_torch.core import subnet as sn
    from repro_torch.models import lm
    cfg = _small_cfg()
    gpu = lm.init_model(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    cpu = lm.from_jax_params(_to_numpy(gpu), device="cpu")
    cfg32 = cfg.replace(dtype="float32")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    with torch.no_grad():
        for sub in sn.enumerate_space(cfg):
            ctrl = sn.make_control(cfg, sub)
            _close_rel(lm.forward(gpu, cfg, {"tokens": toks}, ctrl),
                       lm.forward(cpu, cfg32, {"tokens": toks}, ctrl))
        cg = lm.init_cache(cfg, 2, 32, device=cuda)
        cc = lm.init_cache(cfg32, 2, 32, device="cpu")
        for i in range(6):
            lg, cg = lm.decode_step(gpu, cfg, toks[:, i:i + 1], ctrl, cg, i)
            lc, cc = lm.decode_step(cpu, cfg32, toks[:, i:i + 1], ctrl, cc, i)
            _close_rel(lg, lc)


def test_switch_lm_on_card_matches_cpu_plain_path_for_every_subnet(cuda):
    import numpy as np
    from repro_torch.core import subnet as sn
    from repro_torch.models import lm
    cfg = _small_cfg()
    gpu = lm.init_model(cfg, torch.Generator(device=cuda).manual_seed(1), cuda)
    cpu = lm.from_jax_params(_to_numpy(gpu), device="cpu")
    cfg32 = cfg.replace(dtype="float32")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24))
    with torch.no_grad():
        for sub in sn.enumerate_space(cfg):
            ctrl = sn.make_control(cfg, sub)
            _close_rel(lm.forward(gpu, cfg, {"tokens": toks}, ctrl,
                                  slice_mode="switch"),
                       lm.forward(cpu, cfg32, {"tokens": toks}, ctrl))
            cg = lm.init_cache(cfg, 2, 8, device=cuda)
            cc = lm.init_cache(cfg32, 2, 8, device="cpu")
            for i in range(3):
                lg, cg = lm.decode_step(gpu, cfg, toks[:, i:i + 1], ctrl, cg,
                                        i, slice_mode="switch")
                lc, cc = lm.decode_step(cpu, cfg32, toks[:, i:i + 1], ctrl,
                                        cc, i)
                _close_rel(lg, lc)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.float().cpu().numpy()


def test_executor_on_card_builds_nothing_after_warmup(cuda):
    _executor_builds_nothing_after_warmup(cuda, "mask")


def test_switch_executor_on_card_builds_nothing_after_warmup(cuda):
    _executor_builds_nothing_after_warmup(cuda, "switch")


def _executor_builds_nothing_after_warmup(cuda, slice_mode):
    import numpy as np
    from repro_torch import compat
    from repro_torch.serving.executor import ExecutorConfig, build_executor
    ex = build_executor(_small_cfg(), seed=0, device=cuda,
                        exec_cfg=ExecutorConfig(batch_buckets=(1, 2, 4),
                                                seq_buckets=(16,),
                                                slice_mode=slice_mode))
    ex.warmup(batches=(1, 2, 4), seqs=(16,), decode=True)
    compat.reset_launch_counts()
    with compat.BuildCounter() as bc:
        for idx in range(ex.n_subnets):
            out = ex.prefill(idx, np.ones((3, 11), np.int32))
            assert out.shape == (3, 1000) and np.isfinite(out).all()
        cache = ex.init_cache(3, 16)
        for i in range(4):
            logits, cache = ex.decode_step(ex.n_subnets - 1,
                                           np.ones((3, 1), np.int32), cache, i)
            assert np.isfinite(logits).all()
    assert bc.count == 0
    launches = compat.launch_counts()
    for name in ("flash_attention", "subnet_rmsnorm", "decode_attention"):
        assert launches.get(name, 0) > 0, name
    assert (launches.get("sliced_matmul", 0) > 0) == (slice_mode == "switch")


# --------------------------------------------------------------------------
# the kernels under autograd: each Function's backward against
# torch.autograd of the plain version, on the card
# --------------------------------------------------------------------------


def _grads_match(outs, want_outs, inputs, gen):
    """The gradients through the kernels' Functions (``outs``) equal
    torch.autograd's through the plain versions (``want_outs``) within the
    bf16 tolerance, for one seeded output gradient."""
    outs = outs if isinstance(outs, tuple) else (outs,)
    want_outs = want_outs if isinstance(want_outs, tuple) else (want_outs,)
    assert all(o.grad_fn is not None for o in outs)
    dys = [torch.randn(o.shape, generator=gen, device=o.device).to(o.dtype)
           for o in outs]
    got = torch.autograd.grad(outs, inputs, dys)
    want = torch.autograd.grad(want_outs, inputs, dys)
    for g, w in zip(got, want):
        scale = w.float().abs().max().item()
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                   atol=2e-2 * max(scale, 1.0))
    return got


def _leaf(gen, *shape, dev, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device=dev) * scale
            ).to(dtype).requires_grad_()


@pytest.mark.parametrize("head_width", [None, 6])
def test_flash_attention_backward_matches_plain(cuda, head_width):
    """(8, 12/2, 64, 128), launch/train's shape; inactive heads get no
    gradient."""
    from repro_torch.kernels import ops as kops
    gen = torch.Generator(device=cuda).manual_seed(11)
    q = _leaf(gen, 8, 12, 64, 128, dev=cuda)
    k = _leaf(gen, 8, 2, 64, 128, dev=cuda)
    v = _leaf(gen, 8, 2, 64, 128, dev=cuda)
    hw = None if head_width is None else _i32(head_width, cuda)
    dq, _, _ = _grads_match(
        kops.flash_attention(q, k, v, head_width=hw),
        fa.flash_attention_plain(q, k, v, head_width=hw), (q, k, v), gen)
    if head_width is not None:
        assert (dq[:, ~ref.head_active(12, 2, head_width, cuda)] == 0).all()


@pytest.mark.parametrize("fused", [False, True])
def test_rmsnorm_backward_matches_plain(cuda, fused):
    """512 rows x 1536: the gain gradient in row ``subnet_id`` only."""
    from repro_torch.kernels import ops as kops
    gen = torch.Generator(device=cuda).manual_seed(12)
    x = _leaf(gen, 512, 1536, dev=cuda)
    gamma = (1 + 0.1 * torch.randn((18, 1536), generator=gen, device=cuda)
             ).requires_grad_()
    sid = _i32(7, cuda)
    if fused:
        delta = _leaf(gen, 512, 1536, dev=cuda)
        inputs = (x, delta, gamma)
        got = _grads_match(
            kops.add_subnet_rmsnorm(x, delta, gamma, sid),
            rn.add_subnet_rmsnorm_plain(x, delta, gamma, sid), inputs, gen)
    else:
        inputs = (x, gamma)
        got = _grads_match(kops.subnet_rmsnorm(x, gamma, sid),
                           rn.subnet_rmsnorm_plain(x, gamma, sid), inputs,
                           gen)
    dgamma = got[-1]
    assert (dgamma[torch.arange(18, device=cuda) != 7] == 0).all()


# (rows, K, N, active_in, active_out, segments): FFN up and down and the
# GQA output projection of qwen2-1.5b at B = 8, S = 64, full and half width
SLICED_GRAD_CASES = [(512, 1536, 8960, None, 8960, 1),
                     (512, 1536, 8960, None, 4480, 1),
                     (512, 8960, 1536, 4480, None, 1),
                     (512, 1536, 1536, 768, None, 2),
                     (512, 1536, 1536, 384, None, 2)]


@pytest.mark.parametrize("M,K,N,ai,ao,segments", SLICED_GRAD_CASES)
def test_sliced_matmul_backward_matches_plain(cuda, M, K, N, ai, ao,
                                              segments):
    from repro_torch.kernels import ops as kops
    gen = torch.Generator(device=cuda).manual_seed(13)
    x = _leaf(gen, M, K, dev=cuda)
    w = _leaf(gen, K, N, dev=cuda, scale=K ** -0.5)
    a = None if ai is None else _i32(ai, cuda)
    b = None if ao is None else _i32(ao, cuda)
    dx, dw = _grads_match(
        kops.sliced_matmul(x, w, a, b, segments=segments),
        sm.sliced_matmul_plain(x, w, a, b, segments=segments), (x, w), gen)
    if ao is not None:
        assert (dw[:, ao:] == 0).all()


def test_decode_attention_refuses_grad(cuda):
    """decode_attention has no backward: under grad with an input that
    requires grad it raises, and under no_grad it runs."""
    from repro_torch.kernels import ops as kops
    gen = torch.Generator(device=cuda).manual_seed(14)
    q = _leaf(gen, 2, 12, 1, 128, dev=cuda)
    cache = torch.randn((2, 2, 16, 128), generator=gen, device=cuda
                        ).bfloat16()
    with pytest.raises(RuntimeError, match="no backward"):
        kops.decode_attention(q, cache, cache, _i32(3, cuda))
    with torch.no_grad():
        assert kops.decode_attention(q, cache, cache, _i32(3, cuda)
                                     ).shape == q.shape


def test_training_step_on_card(cuda):
    """Two sandwich steps of a small bf16 model on the card, one in each
    WeightSlice mode: finite loss, the kernels launched, and every leaf
    reached by a gradient."""
    from repro_torch import compat
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import data, optimizer as opt, supernet
    from repro_torch.training.trainer import Trainer, TrainerConfig
    cfg = _small_cfg()
    task = data.SyntheticTask(cfg.vocab_size, 32, 4, order=1)
    ocfg = opt.AdamWConfig(lr=1e-3)
    st = Trainer(cfg, ocfg, TrainerConfig(), task, device=cuda).init_state(0)
    params, state = st.params, st.opt_state
    for i, mode in enumerate(("mask", "switch")):
        step = supernet.make_train_step(cfg, ocfg, slice_mode=mode)
        compat.reset_launch_counts()
        batch = {k: torch.as_tensor(v, device=cuda)
                 for k, v in task.batch(i).items()}
        params, state, m = step(params, state, batch,
                                torch.Generator().manual_seed(i))
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
        n = compat.launch_counts()
        assert n.get("flash_attention", 0) > 0
        assert n.get("subnet_rmsnorm", 0) > 0
        assert (n.get("sliced_matmul", 0) > 0) == (mode == "switch")
    assert all(p.requires_grad for p in tree_leaves(params))


# --------------------------------------------------------------------------
# int8 weights and distribution on the card (chip_smoke.py phase 15)
# --------------------------------------------------------------------------


def test_int8_tree_on_card_equals_cpu_and_walks_close(cuda):
    """``quantize_tree`` of a small bf16 model on the card gives the CPU's
    int8 tree and scales bit for bit, and the int8 prefill through the
    kernels stays within 2e-2 of max |logit| of the CPU's fp32 prefill on
    the same dequantized weights."""
    from repro_torch import compat
    from repro_torch.core import subnet as sn
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.serving import quantize as QZ
    cfg = _small_cfg()
    params = lm.init_model(cfg, torch.Generator(device=cuda).manual_seed(3),
                           cuda)
    q, sc = QZ.quantize_tree(params)
    cpu = dict(zip(("q", "sc"), QZ.quantize_tree(
        tree_map(lambda t: t.cpu(), params))))
    for a, b in zip(tree_leaves(q), tree_leaves(cpu["q"])):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(tree_leaves(sc), tree_leaves(cpu["sc"])):
        assert torch.equal(a.cpu(), b)
    # a full-width projection: 8960 channels of 1536, bf16
    w = _randn(torch.Generator(device=cuda).manual_seed(7), 1536, 8960,
               dev=cuda) * 0.02
    wq, ws = QZ.quantize_tree({"w": w})
    cq, cs = QZ.quantize_tree({"w": w.cpu()})
    assert torch.equal(wq["w"].cpu(), cq["w"])
    assert torch.equal(ws["w"].cpu(), cs["w"])
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(4))
    ctrl = sn.make_control(cfg, sn.max_subnet(cfg))
    compat.reset_launch_counts()
    got = lm.prefill(QZ.dequantize_tree(q, sc), cfg,
                     {"tokens": toks.to(cuda)}, ctrl).float().cpu()
    assert compat.launch_counts().get("flash_attention", 0) > 0
    want = lm.prefill(QZ.dequantize_tree(cpu["q"], cpu["sc"],
                                         dtype=torch.float32),
                      cfg.replace(dtype="float32"), {"tokens": toks},
                      ctrl).float()
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())


def test_nccl_world1_seq_decode_and_sharded_restore(cuda, tmp_path):
    """NCCL at world size 1 on a (1, 1) mesh: ``seq_sharded_decode`` at the
    served decode shapes against the decode kernel, and a checkpoint of a
    placed tree restored onto the plan's placements bit for bit."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed import collectives, elastic
    from repro_torch.distributed.sharding import ShardingPlan
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import checkpoint as ckpt
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        gen = torch.Generator(device=cuda).manual_seed(5)
        q = _randn(gen, 8, 12, 1, 128, dev=cuda)
        k, v = (_randn(gen, 8, 2, 2048, 128, dev=cuda) for _ in range(2))
        want = kops.decode_attention(q, k, v, _i32(1500, cuda))
        kd, vd = (distribute_tensor(t, mesh, [Shard(2), Replicate()])
                  for t in (k, v))
        got = collectives.seq_sharded_decode(mesh, q, kd, vd, 1500)
        torch.testing.assert_close(got.float(), want.float(), **TOL)
        cfg = _small_cfg()
        params = lm.init_model(cfg, torch.Generator(device=cuda).manual_seed(6),
                               cuda)
        plan = ShardingPlan(mesh, cfg)
        ckpt.save(str(tmp_path / "ck"), 1,
                  elastic.reshard_params(params, plan))
        back, _ = ckpt.restore(str(tmp_path / "ck"), params,
                               shardings=plan.params(params), mesh=mesh)
        for a, b in zip(tree_leaves(params), tree_leaves(back)):
            assert torch.equal(b.full_tensor(), a)
    finally:
        dist.destroy_process_group()
