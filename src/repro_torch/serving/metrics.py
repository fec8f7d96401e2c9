"""Success metrics (paper §6.1): SLO attainment (R1) and mean serving
accuracy over SLO-satisfying queries (R2), plus end-to-end latency
percentiles, continuous-batching join counters, and cluster-level
per-replica / load-imbalance aggregation.

Every function is total: empty or all-dropped query sets yield
well-defined finite values (0.0 for latency percentiles and
imbalance), never NaN or a ZeroDivisionError."""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.queue import Query


def slo_attainment(queries: Sequence[Query]) -> float:
    """Fraction of queries completed within their deadline (drops and
    re-enqueue losses count as misses)."""
    if not queries:
        return 1.0
    ok = sum(1 for q in queries
             if q.finish is not None and q.finish <= q.deadline and not q.dropped)
    return ok / len(queries)


def mean_serving_accuracy(queries: Sequence[Query]) -> float:
    """Mean profiled accuracy over queries that satisfied their SLO."""
    accs = [q.served_acc for q in queries
            if q.finish is not None and q.finish <= q.deadline
            and not q.dropped and q.served_acc is not None]
    return float(np.mean(accs)) if accs else 0.0


def goodput(queries: Sequence[Query], duration: float) -> float:
    ok = sum(1 for q in queries
             if q.finish is not None and q.finish <= q.deadline and not q.dropped)
    return ok / max(duration, 1e-9)


def latency_percentiles(queries: Sequence[Query],
                        ps: Tuple[float, ...] = (50, 99)) -> List[float]:
    lats = [q.finish - q.arrival for q in queries
            if q.finish is not None and not q.dropped]
    if not lats:
        return [0.0] * len(ps)                # total on empty/all-dropped
    return [float(np.percentile(lats, p)) for p in ps]


def summarize(queries: Sequence[Query], n_joins: int = 0,
              n_switches: int = 0, n_dispatches: int = 0,
              actuation_seconds: float = 0.0) -> Dict[str, float]:
    """One-stop serving report: SLO attainment, mean serving accuracy,
    p50/p99 end-to-end latency, the continuous-batching join rate
    (fraction of queries admitted into an already-forming batch), and
    the residency accounting — ``switch_rate`` (fraction of batch
    launches that actuated a different subnet than the worker's
    resident one) and total ``actuation_seconds`` paid on switches."""
    p50, p99 = latency_percentiles(queries)
    resolved = sum(1 for q in queries if q.finish is not None or q.dropped)
    return {
        "slo_attainment": slo_attainment(queries),
        "mean_acc": mean_serving_accuracy(queries),
        "served": float(resolved),
        "p50_latency_s": p50,
        "p99_latency_s": p99,
        "join_rate": n_joins / len(queries) if len(queries) else 0.0,
        "switch_rate": n_switches / n_dispatches if n_dispatches else 0.0,
        "actuation_seconds": float(actuation_seconds),
    }


# --------------------------------------------------------------------------
# Cluster aggregation (multi-replica serving plane)
# --------------------------------------------------------------------------


def per_replica_stats(queries: Sequence[Query],
                      replica_ids: Optional[Iterable[int]] = None
                      ) -> Dict[int, Dict[str, float]]:
    """``summarize`` per replica group (keyed by the replica that last
    admitted each query — re-routed queries count where they landed).
    ``replica_ids`` names every replica that existed (autoscaled runs:
    the span keys), so replicas that served nothing still report a
    well-defined all-zero row instead of silently vanishing."""
    by_rid: Dict[int, List[Query]] = {int(r): []
                                      for r in (replica_ids or ())}
    for q in queries:
        by_rid.setdefault(q.replica, []).append(q)
    return {rid: summarize(qs) for rid, qs in sorted(by_rid.items())}


def load_imbalance(queries: Sequence[Query], n_replicas: int = 0,
                   replica_spans: Optional[Dict[int, float]] = None) -> float:
    """Placement-quality metric: max/mean − 1 of per-replica serving
    load (0.0 = perfectly balanced).

    Static clusters compare raw per-replica query *counts*;
    ``n_replicas`` forces the denominator so full-run replicas that
    received nothing count. With ``replica_spans`` (rid -> active
    seconds, the autoscaled path) the comparison is per-replica query
    *rates* (queries per active second): a replica that existed for a
    tenth of the run is judged on its rate over that tenth, not
    punished as a 0-query phantom — and zero-lifetime replicas are
    excluded entirely. Degenerate cases are defined exactly: no
    queries -> 0.0, and a single (counted) replica -> 0.0, since a
    lone replica cannot be imbalanced against itself."""
    if not queries:
        return 0.0
    counts: Dict[int, int] = {}
    for q in queries:
        counts[q.replica] = counts.get(q.replica, 0) + 1
    if replica_spans is not None:
        rates = [counts.get(rid, 0) / span
                 for rid, span in replica_spans.items() if span > 1e-12]
        if len(rates) <= 1:
            return 0.0
        mean = sum(rates) / len(rates)
        return max(rates) / mean - 1.0 if mean > 0 else 0.0
    n = max(n_replicas, len(counts), 1)
    if n <= 1:
        return 0.0
    mean = len(queries) / n
    return max(counts.values()) / mean - 1.0 if mean > 0 else 0.0


def cluster_summarize(queries: Sequence[Query], n_replicas: int = 0,
                      n_joins: int = 0,
                      replica_spans: Optional[Dict[int, float]] = None,
                      n_switches: int = 0, n_dispatches: int = 0,
                      actuation_seconds: float = 0.0
                      ) -> Dict[str, float]:
    """Aggregate serving report plus the load-imbalance metric; the
    per-replica breakdown rides under the ``replicas`` key. With
    ``replica_spans`` (autoscaled runs) the report adds the provisioned
    ``replica_seconds`` and the goodput-per-replica-second efficiency
    figure (SLO-satisfying completions per unit of capacity-time).
    The switch counters aggregate every replica's residency tracker, so
    ``switch_rate`` is cluster-wide (switches per batch launch)."""
    out = summarize(queries, n_joins=n_joins, n_switches=n_switches,
                    n_dispatches=n_dispatches,
                    actuation_seconds=actuation_seconds)
    out["load_imbalance"] = load_imbalance(queries, n_replicas,
                                           replica_spans=replica_spans)
    out["replicas"] = per_replica_stats(
        queries, replica_ids=replica_spans.keys() if replica_spans else None)
    if replica_spans:
        total = sum(replica_spans.values())
        ok = sum(1 for q in queries
                 if q.finish is not None and q.finish <= q.deadline
                 and not q.dropped)
        out["replica_seconds"] = total
        out["goodput_per_replica_second"] = ok / total if total > 0 else 0.0
    return out
