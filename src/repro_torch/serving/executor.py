"""Shape-bucketed, warmed subnet executor behind the serving plane (port of
``repro/serving/executor.py``).

* **Control as data** — each Pareto subnet's control tuple is converted
  once: layer gates stay host numpy (the backbone walks them), widths and
  ``subnet_id`` become 0-d int32 tensors on the device that masks and
  kernels read. Actuating another subnet passes other tensors; no kernel
  is rebuilt and nothing is read back to the host.
* **WeightSlice mode** — ``ExecutorConfig.slice_mode`` is ``mask`` (the
  default: full FLOPs, inactive channels zeroed) or ``switch`` (the
  ``sliced_matmul`` kernel computes only the active FFN and head widths,
  read from the same device tensors). Entries run the step in that mode,
  so warmup builds the sliced kernel too.
* **Shape buckets** — raw ``(batch, seq)`` shapes are right-padded up to
  configured buckets, and each row's logits are taken at its true
  ``length - 1``. The hidden state is gathered there before the head, so
  the ``(B, S, vocab)`` logits are never formed. Right-padding is exact
  where every block is causal and per row: attention, the MLP, and the
  SSM family's Mamba2, mLSTM and sLSTM blocks, whose scans run forward
  in time, so positions ``< length`` never see the pad. It is not exact
  for MoE configs: pad tokens route and take expert capacity like real
  ones (``models/moe.py``), so once capacity drops a padded batch's
  logits differ from the unpadded batch's, as in the JAX executor.
* **Bounded entry cache** — one entry per ``(kind, bucket_batch,
  bucket_seq, tier)`` in an LRU with hit/miss/build/eviction counters
  (surfaced via ``Router.stats()["executor"]``). Building an entry runs
  the step once at its shape, which builds and loads the CUDA library at
  first use; the ``compiles`` counter counts entry builds and
  ``kernel_builds`` the kernel builds they caused.
* **CUDA graphs** — the twin of the reference's AOT executables
  (``ExecutorConfig.use_graphs``, the twin of ``use_aot``). On the card an
  entry captures one graph per distinct ``layer_gate`` pattern of the
  Pareto set at build time: the gates are walked on the host, every other
  control field is data, so one graph serves every subnet of that depth.
  The step runs eagerly on the capture stream first (it builds the
  kernels, sets their attributes and sizes ``sliced_matmul``'s scratch),
  then is captured into one memory pool shared by the executor's graphs;
  ``graph_captures`` counts them (``compat.CaptureCounter`` process-wide).
  A call writes its tokens, lengths or decode index and its subnet's
  control values into the entry's pinned host mirror, copies them in with
  one transfer, replays, and copies the fp32 logits into a pinned host
  buffer; it returns a copy. A decode graph is bound to its entry's own
  cache: the caller's cache is copied in before the replay and back after
  it, so ``decode_step`` still updates ``cache.state`` in place and any
  cache of the bucket works without a capture. A replay calls no kernel
  wrapper, so the launches noted while capturing are added at each
  replay. Garbage that only the cycle collector frees is collected before
  a capture and the collector is off during it, since freeing an earlier
  executor's graphs inside a capture invalidates it. A failed capture or
  replay raises; nothing drops back to eager.
  ``use_graphs=False`` runs the step eagerly on the card, as asked. On a
  CPU tensor the entry runs the same static buffers with the step called
  in place of the replay (decided by the device, as the kernel tiers are).
* **Warmup** — :meth:`SubnetExecutor.warmup` builds (and captures) every
  bucket the profile lets the policy choose, off the serving path, so no
  serving call builds a kernel or captures a graph
  (``repro_torch.compat.BuildCounter`` and ``CaptureCounter`` show it).

The entry cache, the builds and every step run under one lock: ``Router``
workers are threads, an entry's static buffers serve one call at a time,
and the graphs share one memory pool and ``sliced_matmul``'s scratch.
Scheduling stays in ``serving/engine.py``.

With tracing on (``repro_torch/tracing.py``) a call is the span
``executor.step`` (attribute ``Bb``), and its phases ``executor.load``
(the wait for the mirror's last copy, the writes, the copy in),
``executor.replay`` (the graph's replay, or the step run eagerly, and a
decode cache's copies) and ``executor.fetch`` (the logits' copy out, the
synchronize, the host copy).
"""
from __future__ import annotations

import gc
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import os

import numpy as np
import torch

from repro_torch import compat, tracing
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, Stage
from repro_torch.core import operators as ops
from repro_torch.core import subnet as sn
from repro_torch.core.pareto import ParetoPoint, pareto_subnets
from repro_torch.models import lm
from repro_torch.models.attention import with_wo_width

__all__ = ["ExecutorConfig", "SubnetExecutor", "DecodeCache", "bucket_of",
           "build_executor", "build_serving_executor", "serving_config",
           "cut_units", "check_fits", "free_bytes"]


def bucket_of(n: int, buckets: Sequence[int]) -> int:
    """Smallest configured bucket >= ``n``; beyond the largest bucket,
    the next power of two (the cache still grows only log2-many keys,
    never one per raw shape)."""
    if n <= 0:
        raise ValueError(f"bucket_of: need n >= 1, got {n}")
    for b in buckets:
        if b >= n:
            return int(b)
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclass(frozen=True)
class ExecutorConfig:
    """Bucket lattice + cache policy for one :class:`SubnetExecutor`."""

    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
    seq_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256)
    max_entries: int = 32               # LRU cap on warmed entries
    slice_mode: str = "mask"            # WeightSlice: "mask" or "switch"
    use_graphs: bool = True             # one CUDA graph per entry and depth

    def __post_init__(self):
        for name in ("batch_buckets", "seq_buckets"):
            bs = getattr(self, name)
            if not bs or any(b <= 0 for b in bs) or list(bs) != sorted(bs):
                raise ValueError(f"{name} must be sorted positive ints, "
                                 f"got {bs}")
        if self.max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        ops.check_slice_mode(self.slice_mode)


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a cache tree in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    if tree is None:
        return []
    raise TypeError(f"cache leaf of type {type(tree).__name__}")


class _Entry:
    """One warmed ``(kind, Bb, Sb)`` step on static buffers.

    ``args`` is one int32 buffer on the device that the step reads: the
    tokens, then the lengths (prefill) or the decode index, then the
    device fields of the control tuple. ``host`` is its host mirror
    (pinned on the card), so a call's inputs cross in one copy; the fp32
    logits come back through ``out_host``. A decode entry holds its own
    cache ``state``. ``replays`` maps each layer-gate pattern to the
    function that runs the step on these buffers: the replay of its graph
    on the card, the step itself on the CPU. With ``use_graphs=False`` it
    is None, and a call runs the step with its subnet's own control and
    the caller's cache."""

    def __init__(self, ex: "SubnetExecutor", kind: str, Bb: int, Sb: int):
        dev, cuda = ex.device, ex.device.type == "cuda"
        self.kind, self.Bb, self.Sb = kind, Bb, Sb
        S = Sb if kind == "prefill" else 1
        n_aux = Bb if kind == "prefill" else 1
        n = Bb * S + n_aux + len(ex.fields)
        self.args = torch.zeros(n, dtype=torch.int32, device=dev)
        self.host = torch.zeros(n, dtype=torch.int32, pin_memory=cuda)
        self.out_host = torch.empty((Bb, ex.cfg.vocab_size),
                                    dtype=torch.float32, pin_memory=cuda)
        self.tokens = self.args[:Bb * S].view(Bb, S)
        aux = self.args[Bb * S:Bb * S + n_aux]
        self.aux = aux if kind == "prefill" else aux[0]
        ctrl = self.args[Bb * S + n_aux:]
        self.ctrl = {k: ctrl[j] for j, k in enumerate(ex.fields)}
        host = self.host.numpy()
        self.host_tokens = host[:Bb * S].reshape(Bb, S)
        self.host_aux = host[Bb * S:Bb * S + n_aux]
        self.host_ctrl = host[Bb * S + n_aux:]
        self.state = (lm.init_cache(ex.cfg, Bb, Sb,
                                    dtype=ex.params["embed"].dtype,
                                    device=dev)
                      if kind == "decode" else None)
        self.replays: Optional[Dict[bytes, Callable]] = None
        # the last copy out of ``host``: the mirror is written again only
        # once it has crossed
        self.copied = torch.cuda.Event() if cuda else None


@dataclass
class DecodeCache:
    """A bucketed KV cache plus the geometry it was built at. Decode steps
    update ``state`` in place."""

    batch: int                          # bucketed batch
    seq_cap: int                        # bucketed cache capacity
    state: Any = field(repr=False, default=None)


class SubnetExecutor:
    """Executes real subnet forward passes for the serving plane.

    One instance hosts one supernet (``params`` + ``cfg``) and the control
    tuples of its Pareto subnets; every worker thread of a replica shares
    it (weight-shared), so entries and counters are per supernet."""

    def __init__(self, params: Dict, cfg: ArchConfig,
                 points: Optional[Sequence[ParetoPoint]] = None,
                 exec_cfg: Optional[ExecutorConfig] = None):
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.points: List[ParetoPoint] = list(points or pareto_subnets(cfg))
        # the switch-mode width of wo is derived here, once per subnet
        host = [with_wo_width(cfg, sn.make_control(cfg, p.sub))
                for p in self.points]
        self.ctrls = [ops.device_control(c, self.device) for c in host]
        # each subnet's device fields as one host int32 row: a call copies
        # its subnet's row into the entry's static control
        self.fields = tuple(k for k in host[0] if k not in ops.HOST_FIELDS)
        self.rows = np.array([[c[k] for k in self.fields] for c in host],
                             dtype=np.int32)
        # one graph an entry for each distinct depth pattern, captured
        # with the first subnet that has it
        self.patterns: Dict[bytes, int] = {}
        for i, c in enumerate(self.ctrls):
            self.patterns.setdefault(c["layer_gate"].tobytes(), i)
        self.xcfg = exec_cfg or ExecutorConfig()
        self._cache: "OrderedDict[Tuple, _Entry]" = OrderedDict()
        self._lock = threading.RLock()
        self._counters = {"hits": 0, "misses": 0, "compiles": 0,
                          "evictions": 0, "kernel_builds": 0,
                          "graph_captures": 0, "capture_seconds": 0.0,
                          "graph_pool_bytes": 0}
        self._stream = None             # the capture stream (card only)
        self._pool = None               # the graphs' shared memory pool

    # -- introspection ---------------------------------------------------

    @property
    def n_subnets(self) -> int:
        return len(self.points)

    def accs(self) -> List[float]:
        return [p.acc for p in self.points]

    def counters(self) -> Dict[str, float]:
        """Hit/miss/build/eviction counters plus current cache size (read
        via ``Router.stats()["executor"]`` on an executor-backed router)."""
        with self._lock:
            out = {k: float(v) for k, v in self._counters.items()}
            out["entries"] = float(len(self._cache))
            out["hit_rate"] = (out["hits"] / (out["hits"] + out["misses"])
                               if out["hits"] + out["misses"] else 0.0)
            return out

    def cache_keys(self) -> List[Tuple]:
        with self._lock:
            return list(self._cache.keys())

    def _ctrl(self, subnet_idx: int) -> Dict:
        if not 0 <= int(subnet_idx) < self.n_subnets:
            raise ValueError(f"subnet index {subnet_idx} out of range "
                             f"[0, {self.n_subnets})")
        return self.ctrls[int(subnet_idx)]

    # -- bucketed public steps -------------------------------------------

    def prefill(self, subnet_idx: int, tokens,
                lengths: Optional[Sequence[int]] = None) -> np.ndarray:
        """Final-position logits (B, vocab) float32 for a (B, S) int32
        token batch, padded to its (batch, seq) bucket and gathered at each
        row's last real position."""
        tokens = np.asarray(tokens, dtype=np.int32)
        if tokens.ndim != 2:
            raise ValueError(f"prefill wants (B, S) tokens, "
                             f"got shape {tokens.shape}")
        B, S = tokens.shape
        Bb = bucket_of(B, self.xcfg.batch_buckets)
        Sb = bucket_of(S, self.xcfg.seq_buckets)
        lens = np.full((Bb,), Sb, np.int32)
        lens[:B] = S if lengths is None else np.asarray(lengths, np.int32)
        if (Bb, Sb) != (B, S):
            padded = np.zeros((Bb, Sb), np.int32)
            padded[:B, :S] = tokens
            tokens = padded
        return self._run(self._get("prefill", Bb, Sb), subnet_idx, B,
                         tokens, lens)

    def init_cache(self, batch: int, seq_cap: int) -> DecodeCache:
        """Fresh decode cache at the bucketed (batch, capacity)."""
        Bb = bucket_of(batch, self.xcfg.batch_buckets)
        Sb = bucket_of(seq_cap, self.xcfg.seq_buckets)
        state = lm.init_cache(self.cfg, Bb, Sb,
                              dtype=self.params["embed"].dtype,
                              device=self.device)
        return DecodeCache(batch=Bb, seq_cap=Sb, state=state)

    def decode_step(self, subnet_idx: int, tokens, cache: DecodeCache,
                    index: int) -> Tuple[np.ndarray, DecodeCache]:
        """One decode step: (B, 1) int32 tokens against ``cache`` at
        absolute position ``index``. Returns ``(logits (B, vocab),
        cache)``; the cache is updated in place."""
        tokens = np.asarray(tokens, dtype=np.int32)
        B = tokens.shape[0]
        if B > cache.batch:
            raise ValueError(f"batch {B} exceeds cache batch {cache.batch}")
        if not self.cfg.sliding_window and not 0 <= index < cache.seq_cap:
            raise ValueError(f"index {index} outside cache capacity "
                             f"{cache.seq_cap}")
        if B < cache.batch:
            tokens = np.concatenate(
                [tokens, np.zeros((cache.batch - B, 1), np.int32)])
        logits = self._run(self._get("decode", cache.batch, cache.seq_cap),
                           subnet_idx, B, tokens, int(index), cache.state)
        return logits, DecodeCache(cache.batch, cache.seq_cap, cache.state)

    # -- warmup ----------------------------------------------------------

    def warmup(self, batches: Optional[Sequence[int]] = None,
               seqs: Optional[Sequence[int]] = None,
               decode: bool = False) -> Dict[str, float]:
        """Build the bucket lattice off the serving critical path.

        ``batches`` defaults to the configured batch buckets — pass the
        profile's realizable batch sizes so exactly the buckets the policy
        can choose get built. Raises if the lattice exceeds the LRU cap (a
        warmed entry evicted before first use would put building back on
        the critical path)."""
        t0 = time.perf_counter()
        bbs = sorted({bucket_of(b, self.xcfg.batch_buckets)
                      for b in (batches or self.xcfg.batch_buckets)})
        sbs = sorted({bucket_of(s, self.xcfg.seq_buckets)
                      for s in (seqs or self.xcfg.seq_buckets[:1])})
        kinds = ("prefill", "decode") if decode else ("prefill",)
        lattice = [(k, b, s) for k in kinds for b in bbs for s in sbs]
        if len(lattice) > self.xcfg.max_entries:
            raise ValueError(
                f"warmup lattice of {len(lattice)} buckets exceeds "
                f"max_entries={self.xcfg.max_entries}; raise the cap or "
                f"shrink the lattice")
        before = dict(self._counters)
        for kind, b, s in lattice:
            self._get(kind, b, s)
        return {"n_buckets": float(len(lattice)),
                **{k: float(self._counters[c] - before[c]) for k, c in (
                    ("n_compiled", "compiles"),
                    ("kernel_builds", "kernel_builds"),
                    ("graph_captures", "graph_captures"))},
                "seconds": time.perf_counter() - t0}

    # -- serving-stack adapters ------------------------------------------

    def run_prefill(self, subnet_idx: int, batch) -> np.ndarray:
        """``step_fn`` for :func:`runtime.make_supernet_workers`: ``batch``
        is the (B, S) token array; returns host logits (worker threads
        hand numpy back to the event loop)."""
        return self.prefill(int(subnet_idx), batch)

    @staticmethod
    def pad_batch(payloads: List[Any]) -> np.ndarray:
        """``pad_batch`` for make_supernet_workers: stack token rows —
        padding to shape buckets happens inside the executor."""
        return np.stack([np.asarray(p, dtype=np.int32) for p in payloads])

    def make_workers(self, n: int):
        """``n`` WorkerHandles sharing this executor (weight-shared, one
        entry cache)."""
        from repro_torch.serving.runtime import make_supernet_workers
        return make_supernet_workers(n, self.run_prefill, self.pad_batch)

    def profile_step_fns(self, seq_len: int) -> List[Callable[[int], None]]:
        """Per-subnet ``fn(batch)`` closures for
        :func:`profiler.measure_profile` (each returns host logits, so it
        waits for the device)."""
        def mk(i: int):
            return lambda b: self.run_prefill(
                i, np.ones((b, seq_len), np.int32))
        return [mk(i) for i in range(self.n_subnets)]

    def measured_profile(self, batches: Sequence[int] = (1, 2, 4, 8),
                         seq_len: int = 16, **kw):
        """Measured ``LatencyProfile`` over this executor's subnets: wall
        clock per (subnet, batch bucket) on this executor's device. Run
        :meth:`warmup` first so measurement never times a build."""
        from repro_torch.serving.profiler import measure_profile
        return measure_profile(self.profile_step_fns(seq_len), self.accs(),
                               batches=tuple(batches), **kw)

    # -- entry cache -----------------------------------------------------

    def _get(self, kind: str, Bb: int, Sb: int) -> _Entry:
        key = (kind, Bb, Sb, compat.device_tier(self.device))
        with self._lock:
            entry = self._cache.get(key)
            if entry is not None:
                self._cache.move_to_end(key)
                self._counters["hits"] += 1
                return entry
            self._counters["misses"] += 1
            with compat.BuildCounter() as bc:
                entry = self._build(kind, Bb, Sb)
            self._cache[key] = entry
            self._counters["compiles"] += 1
            self._counters["kernel_builds"] += bc.count
            while len(self._cache) > self.xcfg.max_entries:
                self._cache.popitem(last=False)
                self._counters["evictions"] += 1
            return entry

    def _step(self, e: _Entry, ctrl: Dict, state=None) -> torch.Tensor:
        """The step of ``e`` on its static inputs with ``ctrl`` (and the
        decode ``state``): fp32 logits (Bb, vocab)."""
        cfg, params = self.cfg, self.params
        with torch.no_grad():
            if e.kind == "decode":
                logits, _ = lm.decode_step(params, cfg, e.tokens, ctrl, state,
                                           e.aux,
                                           slice_mode=self.xcfg.slice_mode)
                return logits[:, 0].float()
            x = lm.hidden_states(params, cfg, {"tokens": e.tokens}, ctrl,
                                 slice_mode=self.xcfg.slice_mode)
            # causal: the pad never influences positions < length (except
            # through MoE capacity), so the state at length-1 is the
            # unpadded answer
            pos = torch.clamp(e.aux.long() - 1, 0, e.Sb - 1)
            last = x[torch.arange(e.Bb, device=x.device), pos]
            return lm.head_logits(params, cfg, last, ctrl).float()

    def _load(self, e: _Entry, subnet_idx: int, tokens, aux) -> None:
        """Write a call's inputs and its subnet's control values into the
        host mirror and copy them to ``e.args`` in one transfer."""
        if e.copied is not None:
            e.copied.synchronize()
        e.host_tokens[...] = tokens
        e.host_aux[...] = aux
        e.host_ctrl[...] = self.rows[subnet_idx]
        e.args.copy_(e.host, non_blocking=True)
        if e.copied is not None:
            e.copied.record()

    def _run(self, e: _Entry, subnet_idx: int, B: int, tokens, aux,
             state=None) -> np.ndarray:
        """One call of entry ``e``: logits (B, vocab) float32, a copy."""
        ctrl = self._ctrl(subnet_idx)
        with tracing.span("executor.step", Bb=e.Bb), self._lock:
            with tracing.span("executor.load"):
                self._load(e, subnet_idx, tokens, aux)
            with tracing.span("executor.replay"):
                if e.replays is None:
                    out = self._step(e, ctrl, state)
                else:
                    replay = e.replays[ctrl["layer_gate"].tobytes()]
                    if state is not None:
                        torch._foreach_copy_(_leaves(e.state), _leaves(state))
                    out = replay()
                    if state is not None:
                        torch._foreach_copy_(_leaves(state), _leaves(e.state))
            with tracing.span("executor.fetch"):
                e.out_host.copy_(out, non_blocking=True)
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
                return e.out_host.numpy()[:B].copy()

    def _build(self, kind: str, Bb: int, Sb: int) -> _Entry:
        if kind not in ("prefill", "decode"):
            raise ValueError(f"unknown step kind {kind!r}")
        e = _Entry(self, kind, Bb, Sb)
        if not self.xcfg.use_graphs:
            # eager: run the step once at its shape (builds the kernels);
            # each call then passes the caller's cache
            self._load(e, 0, 0, Sb if kind == "prefill" else 0)
            self._step(e, self.ctrls[0], e.state)
            e.state = None
        elif self.device.type == "cuda":
            e.replays = self._capture(e)
        else:
            # the same static buffers, the step called in place of a replay
            e.replays = {key: self._direct(e, i)
                         for key, i in self.patterns.items()}
        return e

    def _static_ctrl(self, e: _Entry, subnet_idx: int) -> Dict:
        """The entry's static control with subnet ``subnet_idx``'s gates."""
        return dict(e.ctrl, layer_gate=self.ctrls[subnet_idx]["layer_gate"])

    def _direct(self, e: _Entry, subnet_idx: int) -> Callable:
        ctrl = self._static_ctrl(e, subnet_idx)
        return lambda: self._step(e, ctrl, e.state)

    def _capture(self, e: _Entry) -> Dict[bytes, Callable]:
        """One CUDA graph of ``e``'s step for each depth pattern, captured
        on the executor's stream into its shared pool; each pattern's
        step runs eagerly on that stream first."""
        dev = self.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        stream, replays = self._stream, {}
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for i in self.patterns.values():
                self._load(e, i, 0, e.Sb if e.kind == "prefill" else 0)
                self._step(e, self._static_ctrl(e, i), e.state)
        stream.synchronize()
        leaves = [t.data_ptr() for t in _leaves(e.state)]
        # garbage that only the cycle collector frees (an executor a served
        # router held: its graphs, pool and pinned buffers) must not be
        # freed inside a capture, which that invalidates: collect it now
        # and keep the collector off until the entry's graphs are captured
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            for key, i in self.patterns.items():
                replays[key] = self._capture_one(e, i, stream)
        finally:
            if collecting:
                gc.enable()
        if [t.data_ptr() for t in _leaves(e.state)] != leaves:
            raise RuntimeError("the decode step replaced a cache leaf; a "
                               "graph needs the cache updated in place")
        torch.cuda.current_stream(dev).wait_stream(stream)
        return replays

    def _capture_one(self, e: _Entry, subnet_idx: int, stream) -> Callable:
        """Capture ``e``'s step with subnet ``subnet_idx``'s depth pattern
        on ``stream``; returns its replay."""
        dev = self.device
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # the capture empties the allocator's cache first; what the card
        # then reserves more is the pool's
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved(dev)
        with compat.LaunchRecorder() as rec:
            with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                  capture_error_mode="thread_local"):
                out = self._step(e, self._static_ctrl(e, subnet_idx), e.state)
        compat.note_capture()
        self._counters["graph_captures"] += 1
        self._counters["capture_seconds"] += time.perf_counter() - t0
        self._counters["graph_pool_bytes"] += (
            torch.cuda.memory_reserved(dev) - held)
        return _replayer(graph, out, dict(rec.counts))


def _replayer(graph, out: torch.Tensor, launches: Dict[str, int]) -> Callable:
    """Replay ``graph`` and count the launches it records; returns its
    static output."""
    def replay():
        graph.replay()
        compat.add_launches(launches)
        return out
    return replay


def build_executor(cfg: ArchConfig, seed: int = 0, device=None,
                   exec_cfg: Optional[ExecutorConfig] = None,
                   ) -> SubnetExecutor:
    """Random supernet parameters for ``cfg`` from a seeded
    ``torch.Generator`` on ``device`` (default: the GPU), wrapped in an
    executor (the ``launch/serve.py --execute real`` entry point)."""
    dev = compat.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return SubnetExecutor(lm.init_model(cfg, gen, dev), cfg,
                          exec_cfg=exec_cfg)


def cut_units(cfg: ArchConfig, units: Optional[int]) -> ArchConfig:
    """``cfg`` with the first ``units`` repeat units of each stage (all of
    them for None)."""
    if units is None:
        return cfg
    return cfg.replace(stages=tuple(Stage(s.pattern, min(units, s.repeat))
                                    for s in cfg.stages))


def free_bytes(device: torch.device) -> int:
    """Memory free on ``device``: the card's, with what PyTorch's allocator
    holds cached but no tensor uses, or the host's for the CPU."""
    if device.type == "cuda":
        return (torch.cuda.mem_get_info(device)[0]
                + torch.cuda.memory_reserved(device)
                - torch.cuda.memory_allocated(device))
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def check_fits(cfg: ArchConfig, available: float,
               need: Optional[float] = None,
               what: Optional[str] = None) -> None:
    """Refuse (MemoryError) a run that needs more than ``available`` bytes:
    by default the model's weights; a trainer passes ``need`` (weights,
    gradients and moments) and ``what`` names them."""
    if need is None:
        need, what = lm.param_bytes(cfg), f"{cfg.dtype} weights"
    if need > available:
        raise MemoryError(
            f"{cfg.name} at {sum(s.repeat for s in cfg.stages)} repeat "
            f"units holds {need / 1e9:.1f} GB of {what}, more than the "
            f"{available / 1e9:.1f} GB free on the device; cut the depth "
            f"with --units")


def serving_config(arch: str, device="cuda", size: Optional[str] = None,
                   units: Optional[int] = None) -> ArchConfig:
    """The config a serving executor for ``arch`` builds: the published
    widths and depth (``size="full"``, the default on ``cuda``), cut to
    the first ``units`` repeat units, or the small fp32 twin
    (``"reduced"``, the default on ``cpu``). A coordinator whose replica
    children build executors profiles this same config, so both sides
    agree on the Pareto set. Refuses a conv or non-token config, which the
    executor does not run, and the reduced twin on the card, whose fp32
    head_dim 32 the CUDA kernels do not take."""
    dev = torch.device(device)
    size = size or ("full" if dev.type == "cuda" else "reduced")
    cfg = get_config(arch)
    if cfg.family == "conv" or cfg.frontend != "token":
        raise ValueError(f"{arch}: the port serves token-frontend LMs "
                         f"(family={cfg.family}, frontend={cfg.frontend})")
    if size == "full":
        return cut_units(cfg, units)
    if size != "reduced":
        raise ValueError(f"size must be 'full' or 'reduced', got {size!r}")
    if units is not None:
        raise ValueError("units cut the full config; not with size='reduced'")
    if dev.type == "cuda":
        raise ValueError("size='reduced' has head_dim 32 in fp32; the CUDA "
                         "kernels take bf16 with head_dim 80, 120 or 128")
    return cfg.reduced()


def build_serving_executor(arch: str, seq_len: int = 16,
                           batches: Sequence[int] = (1, 2, 4, 8),
                           seed: int = 0, device=None,
                           size: Optional[str] = None,
                           units: Optional[int] = None,
                           slice_mode: str = "mask") -> SubnetExecutor:
    """Registry-name entry point for serving children
    (``replica_proc``, ``execute="real"``): build the supernet executor
    for ``serving_config(arch, device, size, units)`` on ``device``
    (default: the GPU) in ``slice_mode``, refusing before it allocates a
    model whose weights do not fit, and warm the ``batches`` x
    ``seq_len`` lattice so the first submit frame never builds a kernel.
    The coordinator must profile the same config for Pareto-set
    agreement."""
    dev = compat.resolve_device(device)
    cfg = serving_config(arch, dev, size, units)
    check_fits(cfg, free_bytes(dev))
    ex = build_executor(cfg, seed=seed, device=dev,
                        exec_cfg=ExecutorConfig(slice_mode=slice_mode))
    ex.warmup(batches=tuple(batches), seqs=(int(seq_len),))
    return ex
