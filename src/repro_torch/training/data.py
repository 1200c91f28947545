"""Deterministic synthetic token pipeline: the port of the JAX package's
``training/data.py``, in numpy, batch for batch bit-identical to it.

Not uniform noise: tokens follow a Zipf marginal with a hash-induced bigram
structure (each token biases the next draw), so a language model has real
structure to learn and the training loss falls, while the stream stays a
pure function of (seed, cursor), which is what makes the data-cursor
checkpoint and resume exact.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import splitmix64


def _zipf_table(vocab: int, alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return (p / p.sum()).cumsum()


class SyntheticTokens:
    """Stateless-addressable token stream: ``batch(i)`` is a pure function
    of (vocab, seq_len, batch_size, seed, i) -> ``{"tokens", "labels"}``,
    int32 [batch_size, seq_len], the labels shifted one token."""

    def __init__(self, vocab: int, seq_len: int, batch_size: int, *,
                 seed: int = 0, alpha: float = 1.1, bigram_strength=0.7):
        self.vocab, self.seq_len, self.batch_size = vocab, seq_len, batch_size
        self.seed = seed
        self.cdf = _zipf_table(vocab, alpha)
        self.bigram_strength = bigram_strength

    def batch(self, index: int) -> dict:
        n = self.batch_size * (self.seq_len + 1)
        base = (np.uint64(self.seed) * np.uint64(0x1000003)
                + np.uint64(index) * np.uint64(n + 1))
        u = splitmix64(base + np.arange(n, dtype=np.uint64))
        unif = (u >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        toks = np.searchsorted(self.cdf, unif).astype(np.int64)
        # bigram structure: with prob bigram_strength, token t+1 is a hash
        # of token t (a deterministic successor): learnable transitions
        succ = (splitmix64(toks.astype(np.uint64) * np.uint64(2654435761))
                % np.uint64(self.vocab)).astype(np.int64)
        gate_u = splitmix64(u ^ np.uint64(0xDEADBEEF))
        gate = (gate_u >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        shifted = np.concatenate([toks[:1], succ[:-1]])
        toks = np.where(gate < self.bigram_strength, shifted, toks)
        toks = toks.reshape(self.batch_size, self.seq_len + 1)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def synthetic_batches(vocab, seq_len, batch_size, *, seed=0, start=0):
    """``(index, batch)`` from ``start`` on, without end."""
    ds = SyntheticTokens(vocab, seq_len, batch_size, seed=seed)
    i = start
    while True:
        yield i, ds.batch(i)
        i += 1
