"""Token data pipeline: the counterpart of src/repro/training/data.py.

Two sources, numpy only and copied with the same draws, so the same seeds
give the same batches as the JAX package's:
  * SyntheticLM: a fixed random-parameter 2nd-order Markov process with
    enough structure that a small model measurably learns it (the training
    examples and tests run on it; no corpus is needed);
  * MemmapDataset: a packed-token binary (np.uint16/uint32 memmap), for
    real corpora.

Both yield dict batches {"tokens": (B, S), "labels": (B, S)} of numpy
int32, labels shifted left by one; the training loop moves them to the
device.
"""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    """Structured synthetic language: a hidden 2nd-order Markov chain over
    ``vocab`` tokens with sparse transitions."""

    def __init__(self, vocab: int, seed: int = 0, branch: int = 8):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        self.branch = branch
        # each (prev2 hash) selects `branch` candidate next tokens
        self.table = rng.integers(0, vocab, size=(4096, branch))
        self.weights = rng.dirichlet(np.ones(branch) * 0.5, size=4096)

    def _state(self, a: int, b: int) -> int:
        return (a * 31 + b * 7) % 4096

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length, np.int32)
        a = int(rng.integers(self.vocab))
        b = int(rng.integers(self.vocab))
        for i in range(length):
            s = self._state(a, b)
            t = int(rng.choice(self.table[s], p=self.weights[s]))
            out[i] = t
            a, b = b, t
        return out

    def batches(self, batch: int, seq: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        while True:
            toks = np.stack([self.sample(rng, seq + 1) for _ in range(batch)])
            yield {
                "tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32),
            }


class MemmapDataset:
    """Packed token binary: tokens stored flat; batches are random windows."""

    def __init__(self, path: str, vocab: int, dtype=np.uint16):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab

    def batches(self, batch: int, seq: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        n = len(self.data) - seq - 1
        while True:
            idx = rng.integers(0, n, size=batch)
            toks = np.stack([self.data[i : i + seq + 1] for i in idx]).astype(np.int32)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
