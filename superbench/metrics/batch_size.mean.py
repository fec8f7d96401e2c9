"""Real rows per served step, over the steps that started in the window."""


def read(run):
    steps = run.window.window_steps()
    return sum(s.rows for s in steps) / len(steps) if steps else None
