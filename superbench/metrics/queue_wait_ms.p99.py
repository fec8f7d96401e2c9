"""99th percentile over the window's served queries of due time to the
start of the step that served them (Router, engine and SlackFit)."""
from superbench.stats import percentile


def read(run):
    steps = run.window.steps
    return percentile([(steps[q.step].t0 - q.due) * 1e3
                       for q in run.window.queries if q.step is not None],
                      99)
