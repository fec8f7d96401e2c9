"""``sliced_matmul``'s least time over its traced kernel time, in percent:
each launch's FLOPs over the bf16 peak or its bytes over HBM's, whichever
is larger (``counts/sliced_matmul.py``), the expert stacks counting the
rows routed to the experts. Only switch mode launches it."""
from superbench.stats import roofline


def read(run):
    return roofline(run, "sliced_matmul_kernel",
                    ["sliced_matmul", "sliced_matmul.experts"])
