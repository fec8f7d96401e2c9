"""The card's time of each ``run_prefill`` call that started in the window,
averaged: a CUDA event on the current stream before the call and one after
it (``serve.Recorder``), summed over the window's steps and divided by
their count. It spans the call on the card's clock: the input's copy, the
graph's kernels, the logits' copy and the synchronize that waits for them."""


def read(run):
    steps = [s for s in run.window.window_steps() if s.device_ms is not None]
    return sum(s.device_ms for s in steps) / len(steps) if steps else None
