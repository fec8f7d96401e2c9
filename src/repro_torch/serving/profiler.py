"""Supernet Profiler (paper §5): latency profiles l_phi(B) over the
Pareto subnets, and the bucketed control space SlackFit operates on.

Profiling is *apriori, off the critical path*. Two sources:
  * analytic — a roofline-style latency model parameterized by a
    HardwareProfile (used by the simulator; the RTX2080Ti profile is
    calibrated so the conv supernet reproduces the paper's Fig 5c
    2-8k QPS dynamic range and Fig 13a bucket structure);
  * measured — wall-clock profiling of the jitted step function on this
    host (used by the real asyncio runtime in serving/runtime.py).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.pareto import ParetoPoint, pareto_subnets, subnet_flops, subnet_weight_bytes

DEFAULT_BATCHES = (1, 2, 4, 8, 16, 32, 64)


@dataclass(frozen=True)
class HardwareProfile:
    name: str
    effective_flops: float      # sustained FLOP/s at B=1 in the model
    hbm_bw: float               # bytes/s, weight-streaming floor
    dispatch_overhead: float    # seconds per dispatched batch
    load_bw: float              # host->device bytes/s (model *loading*,
                                # incl. allocation/setup — paper Fig 1a)
    marginal_frac: float = 0.15 # marginal cost of one extra batch item
                                # relative to the single-item pass


# Calibrated so ofa_resnet reproduces the paper's measured structure:
# Fig 5c (8 workers sustain ~2000 qps on the largest subnet, ~8-9k on
# the smallest), Fig 13a P3 (small nets nearly batch-flat — memory/
# launch bound; large nets batch-linear — compute bound), and Fig 1a
# (loading a model takes longer than B=16 inference on it).
RTX2080TI = HardwareProfile("rtx2080ti", 0.433e12, 308e9, 0.001, 1.5e9,
                            marginal_frac=0.15)
# TPU v5e serving point (effective bf16 serving throughput).
TPU_V5E = HardwareProfile("tpu-v5e", 60e12, 819e9, 0.0005, 50e9,
                          marginal_frac=0.3)


def model_latency(hw: HardwareProfile, flops_per_item: float,
                  weight_bytes: float, batch: int) -> float:
    """Affine-in-batch latency with a weight-streaming floor:

        t(B) = c0 + max( weights/bw,  (f/X) * ((1-m) + m*B) )

    Monotone in batch (P1) and FLOPs (P2); the per-batch slope m*f/X
    grows with model FLOPs, reproducing the paper's P3 (small subnets
    are nearly batch-flat, large subnets batch-linear)."""
    m = hw.marginal_frac
    t_mem = weight_bytes / hw.hbm_bw
    t_comp = flops_per_item * ((1.0 - m) + m * batch) / hw.effective_flops
    return hw.dispatch_overhead + max(t_mem, t_comp)


def loading_latency(hw: HardwareProfile, weight_bytes: float) -> float:
    """Time to page a model's weights onto the device (what Clipper+/
    INFaaS-style switching pays; SubNetAct pays ~0)."""
    return weight_bytes / hw.load_bw


# SubNetAct actuation cost: a control-tuple swap (paper Fig 5b, < 1ms).
SUBNETACT_ACTUATION_S = 50e-6


@dataclass
class LatencyProfile:
    """The (B x phi_pareto) control space + SlackFit's latency buckets."""

    arch: str
    accs: np.ndarray                      # (P,) accuracy per pareto subnet
    batches: Tuple[int, ...]              # (NB,)
    lat: np.ndarray                       # (P, NB) seconds
    points: List[ParetoPoint] = field(default_factory=list)
    n_buckets: int = 32

    # filled by __post_init__
    bucket_edges: np.ndarray = field(init=False)
    bucket_best: List[Optional[Tuple[int, int]]] = field(init=False)
    bucket_members: List[List[Tuple[int, int]]] = field(init=False)

    def __post_init__(self):
        lo, hi = float(self.lat.min()), float(self.lat.max())
        # Log-spaced buckets (paper Fig 13b uses power-of-two latency
        # buckets): fine granularity where tuples cluster (low latency),
        # coarse where choices thin out (I3).
        self.bucket_edges = np.geomspace(lo, hi * 1.0001, self.n_buckets + 1)
        members: List[List[Tuple[int, int]]] = [[] for _ in range(self.n_buckets)]
        for pi in range(self.lat.shape[0]):
            for bi in range(self.lat.shape[1]):
                k = int(np.searchsorted(self.bucket_edges, self.lat[pi, bi],
                                        side="right") - 1)
                k = min(max(k, 0), self.n_buckets - 1)
                members[k].append((pi, bi))
        self.bucket_members = members
        # per-(bucket, batch-cap) best tuple: max batch size (the paper's
        # "opt for a high throughput choice"); ties -> max accuracy
        # (utility Acc*|B|, Lemma A.1).
        nb = len(self.batches)
        self.bucket_best = []
        for mem in members:
            row: List[Optional[Tuple[int, int]]] = []
            for cap in range(nb):
                feas = [t for t in mem if t[1] <= cap]
                row.append(max(feas, key=lambda t: (self.batches[t[1]],
                                                    self.accs[t[0]]))
                           if feas else None)
            self.bucket_best.append(row)

    # -- O(1)/O(log) queries used by the policies ----------------------
    def latency(self, pi: int, batch: int) -> float:
        """l_phi(B) for arbitrary B (interpolate between profiled points)."""
        b = np.asarray(self.batches)
        if batch <= b[0]:
            return float(self.lat[pi, 0])
        j = int(np.searchsorted(b, batch, side="left"))
        if j >= len(b):
            return float(self.lat[pi, -1] * batch / b[-1])
        if b[j] == batch:
            return float(self.lat[pi, j])
        w = (batch - b[j - 1]) / (b[j] - b[j - 1])
        return float(self.lat[pi, j - 1] * (1 - w) + self.lat[pi, j] * w)

    def bucket_of(self, slack: float) -> int:
        """Bucket with latency closest-to-and-below ``slack`` (O(1))."""
        k = int(np.searchsorted(self.bucket_edges, slack, side="right") - 1)
        return min(max(k, 0), self.n_buckets - 1)

    def cap_batch_idx(self, queue_len: Optional[int]) -> int:
        """Largest useful batch index: the smallest profiled batch that
        covers the current queue (a control choice cannot batch queries
        that do not exist)."""
        if queue_len is None:
            return len(self.batches) - 1
        j = int(np.searchsorted(self.batches, max(queue_len, 1)))
        return min(j, len(self.batches) - 1)

    def choose_slackfit(self, slack: float,
                        queue_len: Optional[int] = None) -> Tuple[int, int]:
        """(pareto_idx, batch_idx) per the paper §4.2: the bucket whose
        latency range is closest-to-and-below ``slack`` (every choice in
        it satisfies the head deadline), then the max-batch member over
        realizable batch sizes. If slack falls inside/below the lowest
        bucket, the head may miss regardless — still take the lowest
        bucket's max-batch choice, which drains the queue fastest so the
        successors (later deadlines) meet theirs.
        """
        cap = self.cap_batch_idx(queue_len)
        # largest k with upper edge <= slack (bucket "less than slack")
        k = int(np.searchsorted(self.bucket_edges[1:], slack, side="right") - 1)
        k = min(max(k, 0), self.n_buckets - 1)
        while k >= 0:
            best = self.bucket_best[k][cap]
            if best is not None:
                return best
            k -= 1
        # all buckets empty below cap (cannot happen: B=1 tuples exist)
        return int(self.lat[:, 0].argmin()), 0

    @property
    def n_pareto(self) -> int:
        return len(self.accs)


def build_profile(cfg: ArchConfig, hw: HardwareProfile = RTX2080TI,
                  batches: Sequence[int] = DEFAULT_BATCHES,
                  n_buckets: int = 32) -> LatencyProfile:
    """Analytic profile over Phi_pareto (the simulator's ground truth)."""
    points = pareto_subnets(cfg)
    accs = np.array([p.acc for p in points])
    lat = np.zeros((len(points), len(batches)))
    for i, p in enumerate(points):
        f = subnet_flops(cfg, p.sub)
        wb = subnet_weight_bytes(cfg, p.sub, resident=False)
        for j, b in enumerate(batches):
            lat[i, j] = model_latency(hw, f, wb, b)
    return LatencyProfile(arch=cfg.name, accs=accs, batches=tuple(batches),
                          lat=lat, points=points, n_buckets=n_buckets)


def measure_profile(step_fns: Sequence[Callable[[int], None]],
                    accs: Sequence[float],
                    batches: Sequence[int] = (1, 2, 4, 8),
                    warmup: int = 1, iters: int = 3,
                    n_buckets: int = 12, arch: str = "measured",
                    monotonize: bool = True) -> LatencyProfile:
    """Wall-clock profile: ``step_fns[i](batch)`` runs subnet i on this
    host. The supported measured path — ``launch/serve.py --profile
    measured`` feeds ``SubnetExecutor.profile_step_fns`` through here
    (warm the executor first so no sample times a compile) and serves
    from the result; the quickstart example does the same by hand.

    ``monotonize`` enforces the P1/P2 structure (cummax along batch and
    accuracy) — measurement jitter that inverts the profile would
    otherwise scramble SlackFit's bucket choices."""
    lat = np.zeros((len(step_fns), len(batches)))
    for i, fn in enumerate(step_fns):
        for j, b in enumerate(batches):
            for _ in range(warmup):
                fn(b)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(b)
            lat[i, j] = (time.perf_counter() - t0) / iters
    if monotonize:
        order = np.argsort(np.asarray(accs))
        lat[order] = np.maximum.accumulate(lat[order], axis=0)    # P2
        lat = np.maximum.accumulate(lat, axis=1)                  # P1
    return LatencyProfile(arch=arch, accs=np.asarray(accs, float),
                          batches=tuple(batches), lat=lat, n_buckets=n_buckets)
