"""Operations and bytes of one ``flash_attention`` launch (the kernel of
``repro_torch/csrc/flash_attention.cu``) on a padded prefill batch:
``batch`` rows of ``seq`` positions, causal, within ``window`` keys when
it is set.

Operations: Q K^T and P V over the causal pairs of each of the
``q_heads`` heads the kernel computes. Bytes: Q of those heads, K and V of
every KV head, each read once, and the output of all ``out_heads`` heads
as the kernel returns it (zeros for heads it does not compute).
"""
from __future__ import annotations

from typing import Tuple

BF16 = 2


def causal_pairs(seq: int, window: int = 0) -> int:
    """(query, key) pairs a causal row of ``seq`` positions attends."""
    if not window or window >= seq:
        return seq * (seq + 1) // 2
    return sum(min(i + 1, window) for i in range(seq))


def launch(batch: int, seq: int, q_heads: int, out_heads: int,
           kv_heads: int, head_dim: int,
           window: int = 0) -> Tuple[float, float]:
    """(FLOPs, bytes) of one launch."""
    flops = 4.0 * head_dim * causal_pairs(seq, window) * batch * q_heads
    nbytes = BF16 * batch * seq * head_dim * (q_heads + 2 * kv_heads
                                               + out_heads)
    return flops, float(nbytes)
