"""Operations and bytes of one ``sliced_matmul`` launch (the kernel of
``repro_torch/csrc/sliced_matmul.cu``): ``y = x[:, :k_in] @ w[:k_in,
:k_out]``, zeros past ``k_out`` in an output ``n_out`` wide.

Bytes count the active block's operands, each read once, and the output
as the kernel returns it (its zero columns included). Over a stack of
experts the rows are those routed to the experts, and the weights are
every expert's active block.
"""
from __future__ import annotations

from typing import Tuple

BF16 = 2


def dense(m: int, k_in: int, k_out: int, n_out: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one launch on ``m`` rows."""
    flops = 2.0 * m * k_in * k_out
    nbytes = BF16 * (m * k_in + k_in * k_out + m * n_out)
    return flops, float(nbytes)


def experts(n_experts: int, routed_rows: int, slot_rows: int, k_in: int,
            k_out: int, n_out: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one launch over a stack of ``n_experts``:
    ``routed_rows`` rows routed over all experts, each expert's output
    ``slot_rows`` x ``n_out`` as returned."""
    flops = 2.0 * routed_rows * k_in * k_out
    nbytes = BF16 * (routed_rows * k_in + n_experts * k_in * k_out
                     + n_experts * slot_rows * n_out)
    return flops, float(nbytes)
