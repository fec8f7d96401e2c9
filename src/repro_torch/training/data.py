"""Synthetic-but-learnable data pipeline (copy of ``repro/training/data.py``).

Deterministic, seeded, stateless-by-step (batch i is a pure function of
(seed, i)) — so a restarted/rescheduled trainer resumes mid-epoch with
no data-state checkpointing, and any host can produce any shard
(straggler work-stealing at the input layer).

The task: order-k modular language. Token t+1 = (a1*t1 + ... + ak*tk +
b) mod V with a small noise rate. A transformer learns it quickly, so
training curves actually go down — used by the examples and the
end-to-end training test.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclass(frozen=True)
class SyntheticTask:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order: int = 3
    noise: float = 0.02

    def _coeffs(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + 17)
        return rng.integers(1, self.vocab_size, size=self.order + 1)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Batch ``step`` — pure function of (seed, step)."""
        rng = np.random.default_rng((self.seed, step))
        V, S, B = self.vocab_size, self.seq_len, self.global_batch
        a = self._coeffs()
        toks = np.zeros((B, S + 1), np.int64)
        toks[:, : self.order] = rng.integers(0, V, size=(B, self.order))
        for t in range(self.order, S + 1):
            nxt = a[-1]
            for j in range(self.order):
                nxt = nxt + a[j] * toks[:, t - 1 - j]
            toks[:, t] = nxt % V
        flip = rng.random((B, S + 1)) < self.noise
        toks = np.where(flip, rng.integers(0, V, size=(B, S + 1)), toks)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def iterator(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def embed_batch(task: SyntheticTask, step: int, d_model: int) -> Dict[str, np.ndarray]:
    """For frontend='embed' archs: tokens -> fixed random embeddings
    (the stubbed modality frontend)."""
    b = task.batch(step)
    rng = np.random.default_rng(task.seed + 99)
    table = rng.standard_normal((task.vocab_size, d_model)).astype(np.float32)
    return {"embeds": table[b["tokens"]], "labels": b["labels"]}
