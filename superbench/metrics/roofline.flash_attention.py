"""``flash_attention``'s least time over its traced kernel time, in percent,
at the served padded ``(Bb, Sb)`` with causal work
(``counts/flash_attention.py``)."""
from superbench.stats import roofline


def read(run):
    return roofline(run, "flash_fwd_kernel", ["flash_attention"])
