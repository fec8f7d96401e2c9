"""99th percentile of due time to completion over every query due in the
window that was served."""
from superbench.stats import percentile, served


def read(run):
    return percentile([(q.finish - q.due) * 1e3
                       for q in run.window.queries if served(q)], 99)
