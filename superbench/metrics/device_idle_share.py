"""Share of the traced sub-window in which no kernel or copy ran on the
card; only from a trace that kept every port kernel's launch."""


def read(run):
    tr = run.window.trace
    if tr is None or not tr.intact or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
