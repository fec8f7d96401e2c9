"""The compiled executor on the card: one CUDA graph per warmed entry and
depth pattern, against the eager executor (``use_graphs=False``) over the
same weights, bit for bit, through each kernel's route (mask and switch
mode, the MoE expert stack, decode at head_dim 64, 80, 120 and 128); no
capture after warmup; the launches a replay counts; replays from four
threads; a capture that fails raises; garbage of an earlier executor is
not freed inside a capture. Every test skips without a CUDA
device. This file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_graphs_cuda.py
"""
import gc
import threading
import weakref

import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.configs.base import ArchConfig, ElasticSpec, Stage
from repro_torch.models import lm
from repro_torch.serving.executor import ExecutorConfig, SubnetExecutor

ELASTIC = ElasticSpec(depth_fracs=(1 / 3, 2 / 3, 1.0), ffn_fracs=(0.5, 1.0),
                      head_fracs=(0.5, 1.0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs are captured on the card")
    return torch.device("cuda")


def _cfg(d: int) -> ArchConfig:
    """bf16 twins of three layers at each head dim the kernels take:
    qwen2's G = 6 over QKV bias at d = 128, stablelm-3b's MHA, layernorm
    and 25% rotary at d = 80, h2o-danube-3-4b's G = 4 and a window of 16
    at d = 120, musicgen-medium's MHA at d = 64."""
    kw = {128: dict(n_heads=12, n_kv_heads=2, qkv_bias=True),
          80: dict(n_heads=4, n_kv_heads=4, norm="layernorm",
                   rotary_pct=0.25),
          120: dict(n_heads=8, n_kv_heads=2, sliding_window=16),
          64: dict(n_heads=8, n_kv_heads=8)}[d]
    return ArchConfig(
        name=f"graphs-h{d}", family="dense",
        stages=(Stage(("attn", "mlp"), repeat=3),), d_model=256, d_ff=512,
        vocab_size=1000, head_dim=d, dtype="bfloat16", elastic=ELASTIC, **kw)


def _moe_cfg() -> ArchConfig:
    """mixtral's reduced MoE layers in bf16 at head_dim 128, experts of
    d_ff 512 (the grouped ``sliced_matmul`` over the stack in switch
    mode)."""
    from repro_torch.configs import get_config
    return get_config("mixtral-8x7b").reduced().replace(
        dtype="bfloat16", d_model=256, head_dim=128, n_heads=8,
        n_kv_heads=2, moe_d_ff=512)


CASES = {"mask-h128": (lambda: _cfg(128), "mask"),
         "switch-h128": (lambda: _cfg(128), "switch"),
         "moe-mask": (_moe_cfg, "mask"),
         "moe-switch": (_moe_cfg, "switch"),
         "mask-h80": (lambda: _cfg(80), "mask"),
         "mask-h120": (lambda: _cfg(120), "mask"),
         "mask-h64": (lambda: _cfg(64), "mask")}


def _pair(cfg, mode, dev, seed=0, **kw):
    """(eager, graph) executors over one parameter tree, warmed at batches
    1 and 2, seq 16, prefill and decode."""
    params = lm.init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                           dev)
    out = []
    for graphs in (False, True):
        ex = SubnetExecutor(params, cfg, exec_cfg=ExecutorConfig(
            batch_buckets=(1, 2), seq_buckets=(16, 32), slice_mode=mode,
            use_graphs=graphs, **kw))
        ex.warmup(batches=(1, 2), seqs=(16,), decode=True)
        out.append(ex)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_graph_equals_eager_bit_for_bit(cuda, case):
    """Every subnet's prefill (a ragged batch padded to its bucket) and 20
    greedy decode steps (past the window of 16 at d = 120, so the rolling
    cache wraps): the replayed graph gives the eager step's bits."""
    make, mode = CASES[case]
    cfg = make()
    eager, graph = _pair(cfg, mode, cuda)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    for idx in range(graph.n_subnets):
        want = eager.prefill(idx, toks, lengths=[13, 9])
        got = graph.prefill(idx, toks, lengths=[13, 9])
        assert np.isfinite(got).all()
        assert np.array_equal(got, want), (case, idx, float(
            np.abs(got - want).max()))
    idx = graph.n_subnets - 1
    ce, cg = eager.init_cache(2, 32), graph.init_cache(2, 32)
    tok = toks[:, :1]
    for i in range(20):
        want, ce = eager.decode_step(idx, tok, ce, i)
        got, cg = graph.decode_step(idx, tok, cg, i)
        assert np.array_equal(got, want), (case, i)
        tok = want.argmax(-1).astype(np.int32)[:, None]


def test_warmup_captures_each_depth_pattern_and_nothing_after(cuda):
    """The warmup captures one graph per entry and depth pattern; a pass
    over every subnet and bucket, with new caches, builds and captures
    nothing."""
    cfg = _cfg(128)
    eager, graph = _pair(cfg, "mask", cuda)
    n_patterns = len(graph.patterns)
    assert n_patterns == len({c["layer_gate"].tobytes()
                              for c in graph.ctrls}) >= 2
    assert graph.counters()["graph_captures"] == 4 * n_patterns
    assert eager.counters()["graph_captures"] == 0
    assert graph.counters()["graph_pool_bytes"] > 0
    compiles = graph.counters()["compiles"]
    with compat.BuildCounter() as bc, compat.CaptureCounter() as cc:
        for idx in range(graph.n_subnets):
            for B in (1, 2):
                graph.prefill(idx, np.ones((B, 11), np.int32))
                graph.decode_step(idx, np.ones((B, 1), np.int32),
                                  graph.init_cache(B, 16), 3)
    assert bc.count == 0 and cc.count == 0
    assert graph.counters()["compiles"] == compiles


@pytest.mark.parametrize("mode", ["mask", "switch"])
def test_a_replay_counts_the_launches_of_its_capture(cuda, mode):
    """A replay calls no wrapper: it adds the launches its capture
    recorded, the same counts as the eager step's."""
    eager, graph = _pair(_cfg(128), mode, cuda)
    toks = np.ones((2, 16), np.int32)
    counts = []
    for ex in (eager, graph):
        compat.reset_launch_counts()
        ex.prefill(1, toks)
        ex.decode_step(1, toks[:, :1], ex.init_cache(2, 16), 2)
        counts.append(compat.launch_counts())
    assert counts[0] == counts[1]
    assert counts[1]["flash_attention"] > 0
    assert counts[1]["decode_attention"] > 0
    assert (counts[1].get("sliced_matmul", 0) > 0) == (mode == "switch")


def test_concurrent_replays_from_four_threads(cuda):
    """Four threads replaying through one executor (as ``Router`` workers
    do) get what one thread gets."""
    cfg = _cfg(128)
    _, graph = _pair(cfg, "switch", cuda)
    rng = np.random.default_rng(2)
    toks = [rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
            for _ in range(4)]
    want = [[graph.prefill(i, toks[t]) for i in range(graph.n_subnets)]
            for t in range(4)]
    got = [[None] * graph.n_subnets for _ in range(4)]
    errors = []

    def work(t):
        try:
            for _ in range(3):
                for i in range(graph.n_subnets):
                    got[t][i] = graph.prefill(i, toks[t])
        except Exception as exc:       # reported below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    for t in range(4):
        for i in range(graph.n_subnets):
            assert np.array_equal(got[t][i], want[t][i])


def test_a_capture_that_fails_raises(cuda, monkeypatch):
    """A step that reads the card back on the host cannot be captured: the
    build raises, and nothing drops back to the eager step."""
    cfg = _cfg(128)
    params = lm.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    head = lm.head_logits

    def head_with_a_read(*args, **kw):
        out = head(*args, **kw)
        out.sum().item()
        return out

    monkeypatch.setattr(lm, "head_logits", head_with_a_read)
    ex = SubnetExecutor(params, cfg, exec_cfg=ExecutorConfig(
        batch_buckets=(2,), seq_buckets=(16,)))
    with pytest.raises(RuntimeError):
        ex.prefill(0, np.ones((2, 16), np.int32))
    assert ex.cache_keys() == []


def test_garbage_of_an_earlier_executor_is_not_freed_inside_a_capture(
        cuda, monkeypatch):
    """An executor that only the cycle collector frees (a served router
    holds it in such a cycle) must be gone before a later executor
    captures: freeing its graphs and buffers inside a capture invalidates
    that capture. A collection forced inside every capture finds nothing
    left to free."""
    cfg = _cfg(128)
    params = lm.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    xcfg = ExecutorConfig(batch_buckets=(2,), seq_buckets=(16,),
                          slice_mode="switch")
    old = SubnetExecutor(params, cfg, exec_cfg=xcfg)
    old.warmup(batches=(2,), seqs=(16,), decode=True)
    old.itself = old
    gone = weakref.ref(old)
    del old
    step = SubnetExecutor._step
    collected = []

    def step_collecting(self, *args, **kw):
        if torch.cuda.is_current_stream_capturing():
            collected.append(gone() is None)
            gc.collect()
        return step(self, *args, **kw)

    monkeypatch.setattr(SubnetExecutor, "_step", step_collecting)
    new = SubnetExecutor(params, cfg, exec_cfg=xcfg)
    new.warmup(batches=(2,), seqs=(16,), decode=True)
    assert new.counters()["graph_captures"] == 2 * len(new.patterns)
    assert collected == [True] * (2 * len(new.patterns))
    logits = new.prefill(0, np.ones((2, 16), np.int32))
    assert np.isfinite(logits).all()
