"""Synthetic LM data pipeline: deterministic token streams + batching.

For the end-to-end train driver (examples/train_tiny.py): a mixture of a
Zipf unigram stream and copy/repeat structure so the loss has learnable
signal (pure-uniform tokens would plateau at ln V immediately)."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class SyntheticLMDataset:
    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 0, structure: float = 0.7):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_size
        self.rng = np.random.default_rng(seed)
        self.structure = structure
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)

    def _sample_seq(self) -> np.ndarray:
        n = self.seq + 1
        toks = self.rng.choice(self.vocab, size=n, p=self.unigram)
        # inject copy structure: random spans repeat earlier content
        i = 1
        while i < n:
            if self.rng.random() < self.structure and i > 8:
                span = int(self.rng.integers(4, 16))
                start = int(self.rng.integers(0, i - span)) if i - span > 0 else 0
                span = min(span, n - i, i - start)
                if span > 0:
                    toks[i:i + span] = toks[start:start + span]
                    i += span
                    continue
            i += 1
        return toks

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            batch = np.stack([self._sample_seq() for _ in range(self.batch)])
            yield {"tokens": batch.astype(np.int32)}
