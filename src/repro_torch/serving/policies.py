"""Scheduling policies (paper §4, §A.3-A.5).

All policies are greedy-w.r.t.-time: invoked when a worker frees up,
they map (head-of-EDF slack, queue length) -> a control decision
(pareto-subnet, batch size). Sub-millisecond decision making comes from
the bucketed profile (SlackFit: O(1) bucket + O(1) lookup; MaxAcc /
MaxBatch: O(log B) + O(log S) binary searches).

Also here: the Zero-one ILP objective (Eq. 1) as a brute-force *offline
oracle* on small instances, used by tests/benchmarks to show SlackFit
approximates it (§4.2.1).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.profiler import LatencyProfile


@dataclass(frozen=True)
class Decision:
    pareto_idx: int
    batch_size: int
    # continuous batching: how long the dispatched batch may stay open
    # to in-flight joins (the residual slack after the chosen tuple's
    # latency — waiting longer would endanger the head deadline).
    join_window: float = 0.0


def _join_window(profile: LatencyProfile, pi: int, bi: int,
                 slack: float) -> float:
    return max(0.0, float(slack) - float(profile.lat[pi, bi]))


class Policy:
    """Pluggable policy API (paper §5: 'scheduler provides pluggable
    APIs for different policy implementations').

    ``residency`` is an optional read-only view of the candidate
    worker's subnet residency (serving/residency.py ``ResidencyView``:
    ``.resident`` + ``.switch_cost(pi)``). Residency-blind policies —
    every baseline here — ignore it, which keeps their schedules
    bit-identical to the pre-residency stack; residency-aware variants
    (``slackfit_sticky``) consult it to prefer the resident subnet."""

    name: str = "base"

    def choose(self, profile: LatencyProfile, slack: float,
               queue_len: int, residency=None) -> Optional[Decision]:
        raise NotImplementedError

    def reset(self) -> None:  # per-run state, if any
        pass

    def clone(self) -> "Policy":
        """Fresh instance with the same configuration. Each replica's
        engine owns its own policy object (engines reset and may mutate
        policy state), so a cluster clones the prototype per replica —
        shared mutable policy state must never couple replicas."""
        return type(self)()


class SlackFit(Policy):
    """Bucketed slack-fitting (paper §4.2): pick the latency bucket
    closest-below the head-of-queue slack; within it, the max-batch
    control tuple (over realizable batch sizes)."""

    name = "slackfit"

    def choose(self, profile, slack, queue_len, residency=None):
        pi, bi = profile.choose_slackfit(slack, queue_len)
        return Decision(pi, profile.batches[bi],
                        _join_window(profile, pi, bi, slack))


class MaxBatch(Policy):
    """§A.5: maximize batch first (on the smallest subnet), then pick
    the largest subnet that still fits the slack at that batch.
    O(log B) + O(log S) binary searches on the monotone profile."""

    name = "maxbatch"

    def choose(self, profile, slack, queue_len, residency=None):
        lat = profile.lat
        cap = profile.cap_batch_idx(queue_len)
        # largest realizable B such that the *fastest* subnet fits
        fastest = int(lat[:, 0].argmin())
        fit = np.where(lat[fastest, :cap + 1] <= slack)[0]
        bi = int(fit[-1]) if len(fit) else 0
        # then largest accuracy at that B
        order = np.argsort(profile.accs)
        pi = fastest
        for cand in order:
            if lat[cand, bi] <= slack:
                pi = int(cand)
        return Decision(pi, profile.batches[bi],
                        _join_window(profile, pi, bi, slack))


class MaxAcc(Policy):
    """§A.5: maximize accuracy first (at B=1), then batch."""

    name = "maxacc"

    def choose(self, profile, slack, queue_len, residency=None):
        lat = profile.lat
        cap = profile.cap_batch_idx(queue_len)
        order = np.argsort(profile.accs)
        pi = int(lat[:, 0].argmin())
        for cand in order:
            if lat[cand, 0] <= slack:
                pi = int(cand)
        fit = np.where(lat[pi, :cap + 1] <= slack)[0]
        bi = int(fit[-1]) if len(fit) else 0
        return Decision(pi, profile.batches[bi],
                        _join_window(profile, pi, bi, slack))


class ClipperFixed(Policy):
    """Clipper+/Clockwork/TF-serving baseline (§6.1): a single,
    user-selected accuracy point with adaptive (slack-fitted) batching."""

    def __init__(self, pareto_idx: int, label: Optional[str] = None):
        self.pareto_idx = pareto_idx
        self.name = label or f"clipper+({pareto_idx})"

    def clone(self) -> "ClipperFixed":
        return ClipperFixed(self.pareto_idx, self.name)

    def choose(self, profile, slack, queue_len, residency=None):
        cap = profile.cap_batch_idx(queue_len)
        lat = profile.lat[self.pareto_idx]
        fit = np.where(lat[:cap + 1] <= slack)[0]
        bi = int(fit[-1]) if len(fit) else 0
        return Decision(self.pareto_idx, profile.batches[bi],
                        _join_window(profile, self.pareto_idx, bi, slack))


class INFaaSMinCost(Policy):
    """INFaaS baseline without accuracy thresholds (§6.1): always the
    most cost-efficient = minimum-accuracy model (confirmed with the
    INFaaS authors in the paper), with adaptive batching."""

    name = "infaas"

    def choose(self, profile, slack, queue_len, residency=None):
        pi = int(np.argmin(profile.accs))
        cap = profile.cap_batch_idx(queue_len)
        lat = profile.lat[pi]
        fit = np.where(lat[:cap + 1] <= slack)[0]
        bi = int(fit[-1]) if len(fit) else 0
        return Decision(pi, profile.batches[bi],
                        _join_window(profile, pi, bi, slack))


class StickySlackFit(SlackFit):
    """Residency-aware SlackFit (actuation-stationary serving, the
    "subgraph stationary" direction of Behnam et al. 2023): keep the
    worker on its resident subnet when that subnet still meets the
    slack target at the chosen batch size, instead of actuating
    whichever tuple SlackFit's bucket landed on.

    Stickiness never sacrifices accuracy for free: the resident subnet
    is preferred only when it gives at least the accuracy SlackFit
    chose, OR when the chosen subnet plus its switch cost would miss
    the slack anyway (the weight-loading regime, where a switch costs
    a full page-in and stationarity is the difference between meeting
    and missing the deadline). With no residency view this IS SlackFit,
    bit for bit."""

    name = "slackfit_sticky"

    def choose(self, profile, slack, queue_len, residency=None):
        dec = super().choose(profile, slack, queue_len)
        if dec is None or residency is None:
            return dec
        res = residency.resident
        if res is None or res == dec.pareto_idx:
            return dec
        bi = int(np.searchsorted(profile.batches, dec.batch_size))
        if profile.lat[res, bi] > slack:
            return dec                   # resident can't meet the target
        chosen_with_switch = (float(profile.lat[dec.pareto_idx, bi])
                              + residency.switch_cost(dec.pareto_idx))
        if (profile.accs[res] >= profile.accs[dec.pareto_idx]
                or chosen_with_switch > slack):
            return Decision(res, dec.batch_size,
                            _join_window(profile, res, bi, slack))
        return dec


ALL_POLICIES = {
    "slackfit": SlackFit,
    "maxbatch": MaxBatch,
    "maxacc": MaxAcc,
    "infaas": INFaaSMinCost,
    "slackfit_sticky": StickySlackFit,
}


# --------------------------------------------------------------------------
# Offline oracle (Eq. 1 ZILP, brute-force on small instances)
# --------------------------------------------------------------------------


def oracle_schedule(arrivals: Sequence[float], deadlines: Sequence[float],
                    profile: LatencyProfile, n_workers: int = 1,
                    max_queries: int = 10) -> float:
    """Maximum achievable ILP objective  sum Acc(phi) * |B|  over all
    EDF-prefix batch schedules (exact for the single-worker case under
    the ILP's constraint 1e; used as an upper-bound oracle in tests).

    Queries are sorted by deadline; a batch is a prefix of the remaining
    set (optimal schedules for the per-batch-earliest-deadline
    constraint 1e never benefit from skipping a more urgent query into a
    later batch unless it is dropped, which prefix enumeration with
    drops covers).
    """
    n = len(arrivals)
    if n > max_queries:
        raise ValueError(f"oracle is brute-force; {n} > {max_queries}")
    order = np.argsort(deadlines)
    arr = tuple(float(arrivals[i]) for i in order)
    ddl = tuple(float(deadlines[i]) for i in order)
    lat = profile.lat
    accs = profile.accs
    batches = profile.batches

    @lru_cache(maxsize=None)
    def best(i: int, free_times: Tuple[float, ...]) -> float:
        if i >= n:
            return 0.0
        # option 1: drop query i
        res = best(i + 1, free_times)
        # option 2: serve batch = queries i .. i+b-1 on some worker/subnet
        for w in range(len(free_times)):
            for b in range(1, n - i + 1):
                start = max(free_times[w], max(arr[i:i + b]))
                d_batch = ddl[i]                      # earliest deadline (1e)
                for pi in range(lat.shape[0]):
                    # smallest profiled batch size >= b
                    bi = int(np.searchsorted(batches, b))
                    if bi >= len(batches):
                        continue
                    fin = start + lat[pi, bi]
                    if fin <= d_batch:
                        ft = list(free_times)
                        ft[w] = fin
                        val = accs[pi] * b + best(i + b, tuple(sorted(ft)))
                        res = max(res, val)
        return res

    return best(0, tuple([0.0] * n_workers))
