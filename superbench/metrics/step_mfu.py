"""Useful FLOPs of every step that started in the window (the served
subnet's products for its real rows and tokens, causal attention over its
active heads, the head at the last position; ``counts/lm_step.py``) over
the window's seconds times the bf16 dense peak."""
from superbench.counts import lm_step
from superbench.stats import step_work


def read(run):
    steps = run.window.window_steps()
    if not steps:
        return None
    flops = sum(lm_step.useful_flops(run.arch, step_work(run, s)["ctrl"],
                                     s.rows, run.cell["prompt_tokens"])
                for s in steps)
    return 100.0 * flops / (run.window.seconds * run.peaks["bf16_flops"])
