"""Queries served by their deadline over all queries due in the window
(paper R1); a drop, a time-out or a failure is a miss."""
from superbench.stats import met


def read(run):
    qs = run.window.queries
    return 100.0 * sum(map(met, qs)) / len(qs) if qs else None
