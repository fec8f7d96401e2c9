"""99th percentile over the window's queries of due time to the moment
``submit_query`` returned: how late the benchmark's own generator ran."""
from superbench.stats import percentile


def read(run):
    return percentile([(q.submitted - q.due) * 1e3
                       for q in run.window.queries
                       if q.submitted is not None], 99)
