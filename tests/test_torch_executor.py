"""The PyTorch port's subnet executor: the twins of tests/test_executor.py
(bucketing, bucket reuse, LRU eviction, padded == unpadded, decode parity
with the JAX executor, a Router served with no kernel build after warmup)
plus the port's own rule that the hidden state gathered at ``length-1``
before the head equals forward-then-gather. CPU, fp32."""
import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro.core import subnet as jsn
from repro.models import lm as jlm
from repro.serving import executor as jexec
from repro_torch import compat
from repro_torch.core import subnet as tsn
from repro_torch.models import lm as tlm
from repro_torch.serving.executor import (DecodeCache, ExecutorConfig,
                                          SubnetExecutor, bucket_of,
                                          build_executor)
from test_torch_lm import port_cfg, port_params

TOL = dict(rtol=2e-4, atol=2e-4)      # same framework, other shapes
XTOL = dict(rtol=2e-3, atol=2e-3)     # across frameworks


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the many small ops: under the parallel
    test workers each extra thread only adds contention."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _executor(exec_cfg, cfg=None):
    jcfg = cfg or tiny_dense()
    jparams = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    return SubnetExecutor(port_params(jparams), port_cfg(jcfg),
                          exec_cfg=exec_cfg)


@pytest.fixture(scope="module")
def warmed():
    ex = _executor(ExecutorConfig(batch_buckets=(1, 2, 4), seq_buckets=(8, 16),
                                  max_entries=16))
    ex.warmup(batches=(1, 2, 4), seqs=(8,), decode=True)
    return ex


# --------------------------------------------------------------------------
# bucketing / config plumbing
# --------------------------------------------------------------------------


def test_bucket_of_rounds_up_to_configured_bucket():
    assert bucket_of(1, (1, 2, 4)) == 1
    assert bucket_of(3, (1, 2, 4)) == 4
    assert bucket_of(4, (1, 2, 4)) == 4
    assert bucket_of(5, (1, 2, 4)) == 8
    assert bucket_of(16, (1, 2, 4)) == 16
    with pytest.raises(ValueError):
        bucket_of(0, (1, 2))


def test_executor_config_validates():
    with pytest.raises(ValueError):
        ExecutorConfig(batch_buckets=(4, 2, 1))
    with pytest.raises(ValueError):
        ExecutorConfig(seq_buckets=())
    with pytest.raises(ValueError):
        ExecutorConfig(max_entries=0)


def test_executor_config_validates_slice_mode():
    assert ExecutorConfig().slice_mode == "mask"
    assert ExecutorConfig(slice_mode="switch").slice_mode == "switch"
    with pytest.raises(ValueError, match="unknown WeightSlice mode"):
        ExecutorConfig(slice_mode="Switch")


def test_build_executor_needs_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("the host has CUDA: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_executor(port_cfg(tiny_dense()))
    ex = build_executor(port_cfg(tiny_dense()), device="cpu")
    assert ex.device.type == "cpu"


# --------------------------------------------------------------------------
# warmed executor: actuation is data, buckets are reused
# --------------------------------------------------------------------------


def test_warmed_actuation_builds_nothing(warmed):
    assert warmed.n_subnets >= 3
    before = warmed.counters()
    with compat.BuildCounter() as bc:
        for idx in range(3):
            for B in (1, 2, 3):
                out = warmed.prefill(idx, np.ones((B, 7), np.int32))
                assert out.shape == (B, warmed.cfg.vocab_size)
                assert out.dtype == np.float32
    assert bc.count == 0
    assert warmed.counters()["compiles"] == before["compiles"]


def test_subnets_differ_through_one_entry(warmed):
    toks = np.arange(8, dtype=np.int32)[None, :] % warmed.cfg.vocab_size
    a = warmed.prefill(0, toks)
    b = warmed.prefill(warmed.n_subnets - 1, toks)
    assert not np.allclose(a, b)


def test_bucket_reuse_hits_cache(warmed):
    before = warmed.counters()
    warmed.prefill(0, np.ones((2, 5), np.int32))   # bucket (2, 8)
    warmed.prefill(1, np.ones((2, 8), np.int32))   # same bucket
    after = warmed.counters()
    assert after["compiles"] == before["compiles"]
    assert after["hits"] == before["hits"] + 2


def test_lru_evicts_at_cap():
    ex = _executor(ExecutorConfig(batch_buckets=(1, 2), seq_buckets=(8, 16),
                                  max_entries=2))
    ex.prefill(0, np.ones((1, 8), np.int32))       # (1, 8)
    ex.prefill(0, np.ones((2, 8), np.int32))       # (2, 8)
    ex.prefill(0, np.ones((1, 16), np.int32))      # (1, 16) -> evict (1, 8)
    c = ex.counters()
    assert c["entries"] == 2.0
    assert c["evictions"] == 1.0
    keys = {k[:3] for k in ex.cache_keys()}
    assert ("prefill", 1, 8) not in keys
    before = ex.counters()["compiles"]
    ex.prefill(0, np.ones((1, 8), np.int32))       # rebuilt on return
    assert ex.counters()["compiles"] == before + 1


def test_warmup_refuses_lattice_beyond_cap():
    ex = _executor(ExecutorConfig(batch_buckets=(1, 2), seq_buckets=(8, 16),
                                  max_entries=2))
    with pytest.raises(ValueError, match="lattice"):
        ex.warmup(batches=(1, 2), seqs=(8, 16))


def test_subnet_index_is_checked(warmed):
    with pytest.raises(ValueError, match="out of range"):
        warmed.prefill(warmed.n_subnets, np.ones((1, 8), np.int32))


# --------------------------------------------------------------------------
# padding numerics
# --------------------------------------------------------------------------


def test_padded_prefill_matches_unpadded_and_jax():
    jcfg = tiny_dense()
    jparams = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    ex = SubnetExecutor(port_params(jparams), port_cfg(jcfg),
                        exec_cfg=ExecutorConfig(batch_buckets=(1, 2, 4),
                                                seq_buckets=(8, 16)))
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (3, 7)).astype(np.int32)
    got = ex.prefill(2, toks)                      # pads to (4, 8)
    ctrl = tsn.make_control(ex.cfg, ex.points[2].sub)
    unpadded = tlm.prefill(ex.params, ex.cfg, {"tokens": toks}, ctrl)
    np.testing.assert_allclose(unpadded[:, -1].numpy(), got, **TOL)
    # make_control reads the descriptor's fields only
    want = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                       jsn.make_control(jcfg, ex.points[2].sub))
    np.testing.assert_allclose(np.asarray(want)[:, -1], got, **XTOL)


def test_gather_before_head_equals_forward_then_gather(warmed):
    """Rows with different true lengths in one bucketed batch: the state
    gathered at length-1 and sent through the head equals the full
    (B, S, vocab) logits gathered at length-1."""
    rng = np.random.default_rng(5)
    full = rng.integers(0, warmed.cfg.vocab_size, (2, 8)).astype(np.int32)
    lengths = [5, 8]
    ragged = full.copy()
    ragged[0, 5:] = 0
    got = warmed.prefill(1, ragged, lengths=lengths)
    ctrl = tsn.make_control(warmed.cfg, warmed.points[1].sub)
    logits = tlm.forward(warmed.params, warmed.cfg, {"tokens": ragged}, ctrl)
    for row, L in enumerate(lengths):
        np.testing.assert_allclose(logits[row, L - 1].numpy(), got[row], **TOL)
        solo = tlm.prefill(warmed.params, warmed.cfg,
                           {"tokens": full[row:row + 1, :L]}, ctrl)
        np.testing.assert_allclose(solo[0, -1].numpy(), got[row], **TOL)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


def test_decode_matches_jax_executor():
    jcfg = tiny_dense()
    xc = dict(batch_buckets=(1, 2, 4), seq_buckets=(8, 16))
    jex = jexec.build_executor(jcfg, exec_cfg=jexec.ExecutorConfig(**xc))
    tex = SubnetExecutor(port_params(jex.params), port_cfg(jcfg),
                         exec_cfg=ExecutorConfig(**xc))
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    for idx in (0, tex.n_subnets - 1):
        jc, tc = jex.init_cache(2, 8), tex.init_cache(2, 8)
        assert (tc.batch, tc.seq_cap) == (jc.batch, jc.seq_cap) == (2, 8)
        for i in range(toks.shape[1]):
            want, jc = jex.decode_step(idx, toks[:, i:i + 1], jc, i)
            got, tc = tex.decode_step(idx, toks[:, i:i + 1], tc, i)
            assert isinstance(tc, DecodeCache)
            np.testing.assert_allclose(got, want, **XTOL,
                                       err_msg=f"subnet {idx} step {i}")


def test_decode_pads_small_batches_and_checks_index(warmed):
    dc = warmed.init_cache(2, 8)
    with compat.BuildCounter() as bc:
        logits, _ = warmed.decode_step(0, np.ones((1, 1), np.int32), dc, 0)
    assert bc.count == 0                           # warmed with decode=True
    assert logits.shape == (1, warmed.cfg.vocab_size)
    with pytest.raises(ValueError, match="capacity"):
        warmed.decode_step(0, np.ones((1, 1), np.int32), dc, 8)


# --------------------------------------------------------------------------
# serving through the port's Router
# --------------------------------------------------------------------------


def test_router_serves_24_queries_without_builds(warmed):
    from repro_torch.serving import policies, runtime

    prof = warmed.measured_profile(batches=(1, 2, 4), seq_len=8,
                                   warmup=0, iters=1)

    async def go():
        router = runtime.Router(prof, policies.SlackFit(),
                                warmed.make_workers(3), executor=warmed)
        await router.start()
        futs = [await router.submit(np.full((7,), i, np.int32), slo_s=5.0)
                for i in range(24)]
        results = await asyncio.gather(*futs)
        await router.drain()
        return router.stats(), results

    with compat.BuildCounter() as bc:
        st, results = asyncio.run(go())
    assert bc.count == 0
    assert st["served"] == 24.0
    assert all(pred is not None and pred.shape == (warmed.cfg.vocab_size,)
               for pred, _ in results)
    assert st["executor"]["compiles"] >= 1.0
    assert 0.0 <= st["executor"]["hit_rate"] <= 1.0


def test_launcher_serves_on_cpu():
    from repro_torch.launch import serve
    out = serve.run(["--device", "cpu", "--queries", "12", "--workers", "2"])
    assert out["size"] == "reduced" and out["device"] == "cpu"
    assert out["served"] == out["queries"] >= 1
    assert out["serve_phase_builds"] == 0
    with pytest.raises(SystemExit):
        serve.parse_args(["--device", "cuda", "--size", "reduced"])


# --------------------------------------------------------------------------
# WeightSlice switch mode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_kv", [2, 4])
def test_switch_executor_matches_jax_and_builds_nothing_after_warmup(n_kv):
    """A switch-mode executor against JAX's switch-mode SubnetExecutor on
    the same weights, prefill for every subnet and decode for the smallest
    and largest; after warmup nothing is built or compiled."""
    jcfg = tiny_dense(n_kv_heads=n_kv)
    xc = dict(batch_buckets=(1, 2, 4), seq_buckets=(8, 16), slice_mode="switch")
    jex = jexec.build_executor(jcfg, exec_cfg=jexec.ExecutorConfig(**xc))
    tex = SubnetExecutor(port_params(jex.params), port_cfg(jcfg),
                         exec_cfg=ExecutorConfig(**xc))
    tex.warmup(batches=(2, 4), seqs=(8,), decode=True)
    before = tex.counters()["compiles"]
    rng = np.random.default_rng(13)
    toks = rng.integers(0, jcfg.vocab_size, (3, 7)).astype(np.int32)
    dec = rng.integers(0, jcfg.vocab_size, (2, 5)).astype(np.int32)
    with compat.BuildCounter() as bc:
        for idx in range(tex.n_subnets):
            np.testing.assert_allclose(tex.prefill(idx, toks),
                                       jex.prefill(idx, toks), **XTOL,
                                       err_msg=f"prefill subnet {idx}")
        for idx in (0, tex.n_subnets - 1):
            jc, tc = jex.init_cache(2, 8), tex.init_cache(2, 8)
            for i in range(dec.shape[1]):
                want, jc = jex.decode_step(idx, dec[:, i:i + 1], jc, i)
                got, tc = tex.decode_step(idx, dec[:, i:i + 1], tc, i)
                np.testing.assert_allclose(got, want, **XTOL,
                                           err_msg=f"subnet {idx} step {i}")
    assert bc.count == 0
    assert tex.counters()["compiles"] == before


def test_switch_executor_derives_wo_width_once_per_subnet():
    ex = _executor(ExecutorConfig(slice_mode="switch"))
    for ctrl, p in zip(ex.ctrls, ex.points):
        wid = ctrl["wo_in_width"]
        assert isinstance(wid, torch.Tensor) and wid.dtype == torch.int32
        assert int(wid) == int(ctrl["head_width"]) // 2 * ex.cfg.head_dim
    toks = np.ones((2, 8), np.int32)
    mask = _executor(ExecutorConfig())
    for idx in (0, ex.n_subnets - 1):
        np.testing.assert_allclose(ex.prefill(idx, toks),
                                   mask.prefill(idx, toks), **TOL)


def test_launcher_serves_switch_mode_on_cpu():
    from repro_torch.launch import serve
    out = serve.run(["--device", "cpu", "--queries", "8",
                     "--slice-mode", "switch"])
    assert out["slice_mode"] == "switch"
    assert out["served"] == out["queries"] >= 1
    assert out["serve_phase_builds"] == 0
    assert serve.parse_args([]).slice_mode == "mask"
    with pytest.raises(SystemExit):
        serve.parse_args(["--slice-mode", "crossed"])
