"""The compiled executor's static-buffer entries on the CPU (the twin of
the reference's AOT executables; on the card each entry replays one CUDA
graph per depth pattern, here the step is called on the same buffers):
prefill with a padded batch and ragged lengths and decode against the JAX
executor, the eager path (``use_graphs=False``) equal bit for bit, the
caller's cache updated in place, bucket reuse and the LRU beside the
capture counter, the capture and launch bookkeeping, and the check that
refuses a profiler trace that lost events. CPU, fp32."""
import importlib.util
from collections import Counter
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro.models import lm as jlm
from repro.serving import executor as jexec
from repro_torch import compat
from repro_torch.serving import executor as texec
from repro_torch.serving.executor import ExecutorConfig, SubnetExecutor
from test_torch_lm import port_cfg, port_params

XTOL = dict(rtol=2e-3, atol=2e-3)     # across frameworks
LATTICE = dict(batch_buckets=(1, 2, 4), seq_buckets=(8, 16))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: under the parallel test workers each extra
    thread only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """The JAX executor and the port's on the same tiny dense weights."""
    jcfg = tiny_dense()
    jex = jexec.build_executor(jcfg, exec_cfg=jexec.ExecutorConfig(**LATTICE))
    tex = SubnetExecutor(port_params(jex.params), port_cfg(jcfg),
                         exec_cfg=ExecutorConfig(**LATTICE))
    return jex, tex


def _eager(tex, **kw):
    return SubnetExecutor(tex.params, tex.cfg, exec_cfg=ExecutorConfig(
        use_graphs=False, **{**LATTICE, **kw}))


def test_use_graphs_is_the_default_and_the_twin_of_use_aot():
    assert ExecutorConfig().use_graphs is True
    assert jexec.ExecutorConfig().use_aot is True


def test_entries_run_the_static_buffers_on_the_cpu(pair):
    """On a CPU tensor a graph-mode entry keeps one step a depth pattern
    on its static buffers and captures nothing."""
    _, tex = pair
    with compat.CaptureCounter() as cc:
        tex.prefill(0, np.ones((2, 8), np.int32))
    entry = tex._get("prefill", 2, 8)
    assert cc.count == 0 and tex.counters()["graph_captures"] == 0
    assert set(entry.replays) == set(tex.patterns)
    assert len(tex.patterns) == len({c["layer_gate"].tobytes()
                                     for c in tex.ctrls})
    assert entry.tokens.shape == (2, 8) and entry.aux.shape == (2,)
    assert set(entry.ctrl) == set(tex.fields)
    assert all(t.dim() == 0 and t.dtype == torch.int32
               for t in entry.ctrl.values())
    assert _eager(tex)._get("prefill", 2, 8).replays is None


@pytest.mark.parametrize("idx", [0, 2, -1])
def test_padded_prefill_matches_jax_executor(pair, idx):
    """(3, 5) tokens with ragged lengths pad to the (4, 8) bucket: the
    logits at each row's last real position equal the JAX executor's, and
    the eager path's bit for bit."""
    jex, tex = pair
    idx = idx % tex.n_subnets
    toks = np.random.default_rng(3).integers(
        0, tex.cfg.vocab_size, (3, 5)).astype(np.int32)
    lengths = [5, 2, 4]
    got = tex.prefill(idx, toks, lengths=lengths)
    assert got.shape == (3, tex.cfg.vocab_size) and got.dtype == np.float32
    want = np.asarray(jex.prefill(idx, toks, lengths=lengths))
    np.testing.assert_allclose(got, want, **XTOL)
    assert np.array_equal(got, _eager(tex).prefill(idx, toks,
                                                   lengths=lengths))


def test_prefill_returns_a_copy(pair):
    """The logits are a copy, not a view of the entry's reused buffer."""
    _, tex = pair
    toks = np.ones((2, 8), np.int32)
    a = tex.prefill(0, toks)
    kept = a.copy()
    tex.prefill(tex.n_subnets - 1, toks * 3)
    assert np.array_equal(a, kept)
    assert not np.shares_memory(a, tex._get("prefill", 2, 8).out_host.numpy())


def test_decode_matches_jax_executor_and_updates_cache_in_place(pair):
    """Decode through the entry's own cache: the caller's cache is copied
    in and back, so it is updated in place, and the logits equal the JAX
    executor's and the eager path's."""
    jex, tex = pair
    eager = _eager(tex)
    toks = np.random.default_rng(6).integers(
        0, tex.cfg.vocab_size, (2, 6)).astype(np.int32)
    for idx in (0, tex.n_subnets - 1):
        jc, tc, ec = (jex.init_cache(2, 8), tex.init_cache(2, 8),
                      eager.init_cache(2, 8))
        leaves = texec._leaves(tc.state)
        for i in range(toks.shape[1]):
            want, jc = jex.decode_step(idx, toks[:, i:i + 1], jc, i)
            got, tc = tex.decode_step(idx, toks[:, i:i + 1], tc, i)
            ref, ec = eager.decode_step(idx, toks[:, i:i + 1], ec, i)
            np.testing.assert_allclose(got, np.asarray(want), **XTOL,
                                       err_msg=f"subnet {idx} step {i}")
            assert np.array_equal(got, ref)
        assert all(a is b for a, b in zip(texec._leaves(tc.state), leaves))
        for a, b in zip(texec._leaves(tc.state), texec._leaves(ec.state)):
            assert torch.equal(a, b)


def test_two_caches_of_one_bucket_interleave(pair):
    """Two caches of the same bucket, stepped in turns, each give what it
    gives alone: the entry's cache holds no state between calls."""
    _, tex = pair
    rng = np.random.default_rng(7)
    a, b = (rng.integers(0, tex.cfg.vocab_size, (2, 4)).astype(np.int32)
            for _ in range(2))
    alone = []
    for toks in (a, b):
        c, outs = tex.init_cache(2, 8), []
        for i in range(4):
            out, c = tex.decode_step(1, toks[:, i:i + 1], c, i)
            outs.append(out)
        alone.append(outs)
    ca, cb = tex.init_cache(2, 8), tex.init_cache(2, 8)
    for i in range(4):
        got_a, ca = tex.decode_step(1, a[:, i:i + 1], ca, i)
        got_b, cb = tex.decode_step(1, b[:, i:i + 1], cb, i)
        assert np.array_equal(got_a, alone[0][i])
        assert np.array_equal(got_b, alone[1][i])


def test_bucket_reuse_and_lru_beside_the_capture_counter(pair):
    """Shapes of one bucket share its entry; the LRU evicts at its cap and
    rebuilds on return; the counters carry ``graph_captures`` (0 on the
    CPU) and warmup reports it."""
    _, tex = pair
    ex = SubnetExecutor(tex.params, tex.cfg, exec_cfg=ExecutorConfig(
        batch_buckets=(1, 2), seq_buckets=(8, 16), max_entries=2))
    warm = ex.warmup(batches=(1, 2), seqs=(8,))
    assert warm["n_compiled"] == 2.0 and warm["graph_captures"] == 0.0
    before = ex.counters()
    ex.prefill(0, np.ones((2, 5), np.int32))       # bucket (2, 8)
    ex.prefill(1, np.ones((2, 8), np.int32))       # same bucket
    after = ex.counters()
    assert after["hits"] == before["hits"] + 2
    assert after["compiles"] == before["compiles"]
    assert after["graph_captures"] == 0.0
    ex.prefill(0, np.ones((1, 16), np.int32))      # evicts (1, 8)
    assert ex.counters()["evictions"] == 1.0
    assert ("prefill", 1, 8) not in {k[:3] for k in ex.cache_keys()}
    ex.prefill(0, np.ones((1, 8), np.int32))       # rebuilt
    assert ex.counters()["compiles"] == after["compiles"] + 2


def test_no_build_or_capture_after_warmup(pair):
    """A pass over every subnet and bucket of the warmed lattice builds no
    entry, no kernel and captures no graph."""
    _, tex = pair
    ex = SubnetExecutor(tex.params, tex.cfg,
                        exec_cfg=ExecutorConfig(**LATTICE))
    ex.warmup(batches=(1, 2, 4), seqs=(8,), decode=True)
    compiles = ex.counters()["compiles"]
    with compat.BuildCounter() as bc, compat.CaptureCounter() as cc:
        for idx in range(ex.n_subnets):
            for B in (1, 2, 3):
                ex.prefill(idx, np.ones((B, 6), np.int32))
                ex.decode_step(idx, np.ones((B, 1), np.int32),
                               ex.init_cache(B, 8), 0)
    assert bc.count == 0 and cc.count == 0
    assert ex.counters()["compiles"] == compiles


def test_capture_counter_counts_captures():
    with compat.CaptureCounter() as cc:
        compat.note_capture()
        compat.note_capture(2)
    assert cc.count == 3
    with compat.CaptureCounter() as cc:
        pass
    assert cc.count == 0


def test_launches_recorded_at_capture_are_added_at_each_replay():
    """Launches noted inside a LaunchRecorder go to the recorder, not to
    the process counts; a replay adds what its capture recorded."""

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    compat.reset_launch_counts()
    compat.note_launch("flash_attention")
    with compat.LaunchRecorder() as rec:
        compat.note_launch("subnet_rmsnorm")
        compat.note_launch("subnet_rmsnorm")
        compat.note_launch("flash_attention")
    assert compat.launch_counts() == {"flash_attention": 1}
    assert rec.counts == {"subnet_rmsnorm": 2, "flash_attention": 1}
    out = torch.zeros(2)
    replay = texec._replayer(Graph(), out, dict(rec.counts))
    assert replay() is out and replay() is out
    assert Graph.replays == 2
    assert compat.launch_counts() == {"flash_attention": 3,
                                      "subnet_rmsnorm": 4}
    with compat.LaunchRecorder():
        with pytest.raises(RuntimeError, match="nest"):
            compat.LaunchRecorder().__enter__()
    compat.reset_launch_counts()


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("many,intact", [
    # every kernel n times its one-call count
    ({"gemm": 40, "norm": 60, "dequant": 8}, True),
    # the most frequent kernel whole, a rarer one short: the old check kept
    # this trace
    ({"gemm": 40, "norm": 60, "dequant": 3}, False),
    # a kernel lost altogether
    ({"gemm": 40, "norm": 60}, False),
    # an event that one call does not run
    ({"gemm": 40, "norm": 60, "dequant": 8, "fill": 1}, False),
    # more than n times
    ({"gemm": 42, "norm": 60, "dequant": 8}, False),
])
def test_trace_check_refuses_a_trace_that_lost_events(many, intact):
    """``chip_smoke.trace_intact``: each kernel name of a trace of n calls
    must count n times its count in a trace of one call."""
    cs = _chip_smoke()
    one = Counter({"gemm": 10, "norm": 15, "dequant": 2})
    assert cs.trace_intact(one, Counter(many), 4) is intact
    assert cs.trace_intact(Counter(), Counter(), 4) is False
