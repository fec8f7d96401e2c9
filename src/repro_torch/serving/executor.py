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
* **Warmup** — :meth:`SubnetExecutor.warmup` builds every bucket the
  profile lets the policy choose, off the serving path, so no serving call
  builds a kernel (``repro_torch.compat.BuildCounter`` shows it).

The decode cache is updated in place (the JAX executor donates it). The
entry cache and its first-use builds are guarded by a lock: ``Router``
workers are threads. Scheduling stays in ``serving/engine.py``.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import os

import numpy as np
import torch

from repro_torch import compat
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

    def __post_init__(self):
        for name in ("batch_buckets", "seq_buckets"):
            bs = getattr(self, name)
            if not bs or any(b <= 0 for b in bs) or list(bs) != sorted(bs):
                raise ValueError(f"{name} must be sorted positive ints, "
                                 f"got {bs}")
        if self.max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        ops.check_slice_mode(self.slice_mode)


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
        self.ctrls = [ops.device_control(
            with_wo_width(cfg, sn.make_control(cfg, p.sub)), self.device)
            for p in self.points]
        self.xcfg = exec_cfg or ExecutorConfig()
        self._cache: "OrderedDict[Tuple, Callable]" = OrderedDict()
        self._lock = threading.RLock()
        self._counters = {"hits": 0, "misses": 0, "compiles": 0,
                          "evictions": 0, "kernel_builds": 0}

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
        fn = self._get("prefill", Bb, Sb)
        return fn(subnet_idx, tokens, lens)[:B]

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
        fn = self._get("decode", cache.batch, cache.seq_cap)
        logits = fn(subnet_idx, tokens, cache.state, int(index))
        return logits[:B], DecodeCache(cache.batch, cache.seq_cap, cache.state)

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
                "n_compiled": float(self._counters["compiles"]
                                    - before["compiles"]),
                "kernel_builds": float(self._counters["kernel_builds"]
                                       - before["kernel_builds"]),
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

    def _get(self, kind: str, Bb: int, Sb: int) -> Callable:
        key = (kind, Bb, Sb, compat.device_tier(self.device))
        with self._lock:
            fn = self._cache.get(key)
            if fn is not None:
                self._cache.move_to_end(key)
                self._counters["hits"] += 1
                return fn
            self._counters["misses"] += 1
            with compat.BuildCounter() as bc:
                fn = self._build(kind, Bb, Sb)
            self._cache[key] = fn
            self._counters["compiles"] += 1
            self._counters["kernel_builds"] += bc.count
            while len(self._cache) > self.xcfg.max_entries:
                self._cache.popitem(last=False)
                self._counters["evictions"] += 1
            return fn

    def _build(self, kind: str, Bb: int, Sb: int) -> Callable:
        cfg, params, dev = self.cfg, self.params, self.device
        slice_mode = self.xcfg.slice_mode
        if kind == "prefill":
            @torch.no_grad()
            def fn(subnet_idx, tokens, lengths):
                ctrl = self._ctrl(subnet_idx)
                tok = torch.tensor(tokens, device=dev)
                lens = torch.tensor(lengths, device=dev)
                x = lm.hidden_states(params, cfg, {"tokens": tok}, ctrl,
                                     slice_mode=slice_mode)
                # causal: the pad never influences positions < length
                # (except through MoE capacity), so the state at length-1
                # is the unpadded answer
                pos = torch.clamp(lens.long() - 1, 0, tok.shape[1] - 1)
                last = x[torch.arange(x.shape[0], device=dev), pos]
                logits = lm.head_logits(params, cfg, last, ctrl)
                return logits.float().cpu().numpy()

            fn(0, np.zeros((Bb, Sb), np.int32), np.full((Bb,), Sb, np.int32))
        elif kind == "decode":
            @torch.no_grad()
            def fn(subnet_idx, tokens, state, index):  # noqa: F811
                ctrl = self._ctrl(subnet_idx)
                tok = torch.tensor(tokens, device=dev)
                idx = torch.full((), index, dtype=torch.int32, device=dev)
                logits, _ = lm.decode_step(params, cfg, tok, ctrl, state,
                                           idx, slice_mode=slice_mode)
                return logits[:, 0].float().cpu().numpy()

            scratch = self.init_cache(Bb, Sb).state
            fn(0, np.zeros((Bb, 1), np.int32), scratch, 0)
        else:
            raise ValueError(f"unknown step kind {kind!r}")
        return fn


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


def check_fits(cfg: ArchConfig, available: float) -> None:
    """Refuse (MemoryError) a model whose weights exceed ``available``
    bytes."""
    need = lm.param_bytes(cfg)
    if need > available:
        raise MemoryError(
            f"{cfg.name} at {sum(s.repeat for s in cfg.stages)} repeat "
            f"units holds {need / 1e9:.1f} GB of {cfg.dtype} weights, more "
            f"than the {available / 1e9:.1f} GB free on the device; cut "
            f"the depth with --units")


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
