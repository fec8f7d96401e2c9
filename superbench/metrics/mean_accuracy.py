"""Mean frozen Pareto accuracy of the subnet that served each query that
met its SLO (paper R2)."""
from superbench.stats import met


def read(run):
    steps, points = run.window.steps, run.points
    accs = [points[steps[q.step].subnet]["acc"] for q in run.window.queries
            if met(q) and q.step is not None]
    return sum(accs) / len(accs) if accs else None
