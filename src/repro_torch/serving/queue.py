"""Queries and the router's global earliest-deadline-first queue
(paper §5: "queries ... are enqueued to a global EDF queue")."""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass(order=True)
class Query:
    deadline: float
    seq: int = field(compare=True)          # FIFO tie-break
    arrival: float = field(compare=False, default=0.0)
    qid: int = field(compare=False, default=0)
    # replica group that (last) admitted the query; stamped by the
    # engine so completion records carry serving placement
    replica: int = field(compare=False, default=0)
    # True once a queue has assigned ``seq``: a re-pushed query (fault
    # re-enqueue, replica-death re-route) keeps its first-assigned seq
    # so it never loses its FIFO tie-break position to later arrivals
    seq_assigned: bool = field(compare=False, default=False)
    # filled at completion
    finish: Optional[float] = field(compare=False, default=None)
    served_acc: Optional[float] = field(compare=False, default=None)
    dropped: bool = field(compare=False, default=False)
    # dropped because the router drained (shutdown timeout) with the
    # query still unresolved — distinct from the policy's infeasible
    # drops, so operators can tell overload from shutdown loss
    timed_out: bool = field(compare=False, default=False)


class EDFQueue:
    """Earliest-deadline-first priority queue with O(log n) push/pop and
    O(1) head-slack lookup (§A.3: "sub-ms O(1) EDF queue lookup")."""

    def __init__(self):
        self._heap: List[Query] = []
        self._next_seq = 0

    def push(self, q: Query) -> None:
        if not q.seq_assigned:
            q.seq = self._next_seq
            q.seq_assigned = True
            self._next_seq += 1
        else:
            # re-push: keep the first-assigned seq so a fault-re-enqueued
            # or drain-re-routed query retains its FIFO position at an
            # equal deadline; advance this queue's counter past it so
            # genuinely-later arrivals still sort behind it
            self._next_seq = max(self._next_seq, q.seq + 1)
        heapq.heappush(self._heap, q)

    def pop(self) -> Query:
        return heapq.heappop(self._heap)

    def peek(self) -> Optional[Query]:
        return self._heap[0] if self._heap else None

    def head_slack(self, now: float) -> Optional[float]:
        """Remaining slack of the most urgent query (SlackFit's signal)."""
        return self._heap[0].deadline - now if self._heap else None

    def pop_batch(self, n: int) -> List[Query]:
        """Dequeue the n most urgent queries (clamped to queue length;
        n <= 0 dequeues nothing)."""
        return [heapq.heappop(self._heap)
                for _ in range(min(max(n, 0), len(self._heap)))]

    def drain(self) -> List[Query]:
        """Dequeue everything, most urgent first (router shutdown)."""
        return self.pop_batch(len(self._heap))

    def count_more_urgent(self, deadline: float) -> int:
        """Queries that would be served before a hypothetical arrival
        with ``deadline`` (EDF order). O(n) heap scan — placement
        introspection only, never on the per-query scheduling path."""
        return sum(1 for q in self._heap if q.deadline <= deadline)

    def drop_expired(self, now: float, min_service: float) -> List[Query]:
        """Drop queries that cannot possibly meet their deadline even at
        the fastest control choice (the paper's infeasible-query drop)."""
        dropped = []
        while self._heap and self._heap[0].deadline - now < min_service:
            q = heapq.heappop(self._heap)
            q.dropped = True
            dropped.append(q)
        return dropped

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
