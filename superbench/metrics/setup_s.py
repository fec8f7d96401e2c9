"""Process start to the window's first due time: imports, kernels, weights,
warmup and graph captures, the measured profile and the lead-in."""


def read(run):
    return run.setup_s
