"""The one traffic generator: every mix is a data file of parameters it reads.

Every seed gets the same work: sizes are stratified, the quantiles
(k + 0.5) / n of each distribution over every block of ``block`` requests,
and the seed only permutes them within the block (and draws the token ids
and each request's sampling seed).  So two seeds differ in order, not in
how much there is to do, and their runs spread like two runs of one seed.

A mix file holds:
  ``loop``        "closed": ``initial`` callers, each sending its next
                  request when the last one finished;
  ``prompt_len``, ``max_new``: {"dist": "loguniform" | "uniform", "min", "max"}
                  (integers, both ends included);
  ``initial``     how many requests set-up submits at once; their lengths
                  are stratified over the same distributions, except that
                  ``max_new`` is the remaining part of a request met in mid
                  flight (``residual_quantile``): the pool starts in the mix
                  it keeps once running, instead of with every request fresh;
  ``block``       the stratification block;
  and the engine's settings, which ``loops.build_engine`` reads.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SIZES, TOKENS, SEEDS, INITIAL = 1, 2, 3, 6


def seed_key(seed: int) -> int:
    """Any whole number as a non-negative seed for numpy's SeedSequence."""
    return int(seed) % (1 << 64)


def stream_rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed_key(seed), *stream])


def quantile(dist: dict, u: np.ndarray) -> np.ndarray:
    """The integer value of ``dist`` at cumulative probabilities ``u``."""
    lo, hi = int(dist["min"]), int(dist["max"])
    if dist["dist"] == "loguniform":
        # a continuous log-uniform over [lo, hi + 1), floored: every integer in [lo, hi]
        return np.floor(np.exp(np.log(lo) + u * (np.log(hi + 1) - np.log(lo)))).astype(np.int64).clip(lo, hi)
    if dist["dist"] == "uniform":
        return (lo + np.floor(u * (hi - lo + 1))).astype(np.int64).clip(lo, hi)
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def pmf(dist: dict) -> tuple[np.ndarray, np.ndarray]:
    """(values, probabilities) of the integer distribution."""
    lo, hi = int(dist["min"]), int(dist["max"])
    vals = np.arange(lo, hi + 1)
    if dist["dist"] == "loguniform":
        p = np.log(vals + 1) - np.log(vals)
    elif dist["dist"] == "uniform":
        p = np.ones(len(vals))
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return vals, p / p.sum()


def residual_quantile(dist: dict, u: np.ndarray) -> np.ndarray:
    """Quantiles of the tokens still to come in a request met in mid flight
    (a renewal process's equilibrium residual): P(R = r) is proportional to
    P(L >= r), r = 1 .. max."""
    vals, p = pmf(dist)
    r = np.arange(1, int(vals[-1]) + 1)
    tail = np.array([p[vals >= x].sum() for x in r])
    cdf = np.cumsum(tail / tail.sum())
    return r[np.searchsorted(cdf, u, side="left").clip(0, len(r) - 1)]


def stratified(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


@dataclass
class Request:
    index: int
    prompt: list
    max_new: int
    seed: int


class Traffic:
    """The requests of one mix for one seed, by index (``request(i)``) and,
    for set-up, ``initial_request(j)``."""

    def __init__(self, spec: dict, vocab: int, seed: int):
        self.spec, self.vocab, self.seed = spec, int(vocab), seed
        self.block = int(spec["block"])
        self._blocks: dict = {}
        self._initial = None

    def _block(self, b: int) -> tuple[np.ndarray, np.ndarray]:
        got = self._blocks.get(b)
        if got is None:
            u = stratified(self.block)
            rng = stream_rng(self.seed, SIZES, b)
            got = (quantile(self.spec["prompt_len"], u)[rng.permutation(self.block)],
                   quantile(self.spec["max_new"], u)[rng.permutation(self.block)])
            self._blocks[b] = got
        return got

    def _make(self, index: int, stream: int, prompt_len: int, max_new: int) -> Request:
        tok = stream_rng(self.seed, TOKENS, stream, index).integers(0, self.vocab, size=int(prompt_len))
        sd = int(stream_rng(self.seed, SEEDS, stream, index).integers(0, 2**31 - 1))
        return Request(index, tok.tolist(), int(max_new), sd)

    def request(self, i: int) -> Request:
        pl, mn = self._block(i // self.block)
        return self._make(i, 0, pl[i % self.block], mn[i % self.block])

    def initial_request(self, j: int) -> Request:
        if self._initial is None:
            n = int(self.spec["initial"])
            u = stratified(n)
            rng = stream_rng(self.seed, INITIAL)
            self._initial = (quantile(self.spec["prompt_len"], u)[rng.permutation(n)],
                             residual_quantile(self.spec["max_new"], u)[rng.permutation(n)])
        pl, mn = self._initial
        return self._make(j, 1, pl[j], mn[j])
