"""Host wall of each ``run_prefill`` call that started in the window."""


def read(run):
    steps = run.window.window_steps()
    return (1e3 * sum(s.t1 - s.t0 for s in steps) / len(steps)
            if steps else None)
