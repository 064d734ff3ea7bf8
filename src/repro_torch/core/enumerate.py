"""Exact enumeration machinery for losslessness verification.

Losslessness of one verify round: let D(block) be the distribution of the
emitted block (accepted path + correction token).  Future rounds continue
from the block's end with exact target conditionals (by induction), so the
overall process is target-distributed iff for every string y_{1:n}:

    G(y_{1:n}) :=  sum_{m < n} D(y_{1:m}) * prod_{i=m+1..n} p(y_i|y_{<i})
                 + P(block has prefix y_{1:n})
                =  prod_{i=1..n} p(y_i|y_{<i})

We verify this for all strings up to a given length by enumerating *both*
draft-tree randomness and verifier randomness exactly.
"""
from __future__ import annotations

import itertools
import zlib

import numpy as np

from repro_torch.core.trees import DraftTree, attach_target


class RandomModel:
    """Deterministic random (p, q) tables per context; small vocab."""

    def __init__(self, vocab: int, seed: int = 0, divergence: float = 1.0, zeros: bool = False):
        self.vocab = vocab
        self.seed = seed
        self.divergence = divergence
        self.zeros = zeros
        self._cache: dict = {}

    def _dists(self, ctx: tuple):
        if ctx not in self._cache:
            rng = np.random.default_rng(zlib.crc32(repr(("m", self.seed, ctx)).encode()))
            p = rng.dirichlet(np.ones(self.vocab))
            noise = rng.dirichlet(np.ones(self.vocab))
            q = (1 - self.divergence) * p + self.divergence * noise
            if self.zeros and self.vocab >= 3:
                # exercise disjoint-support edge cases
                p = p.copy()
                q = q.copy()
                p[rng.integers(self.vocab)] = 0.0
                q[rng.integers(self.vocab)] = 0.0
                p = p / p.sum()
                q = q / q.sum()
            self._cache[ctx] = (p, q)
        return self._cache[ctx]

    def p(self, ctx):
        return self._dists(tuple(ctx))[0]

    def q(self, ctx):
        return self._dists(tuple(ctx))[1]


def build_tree_from_draws(model: RandomModel, K: int, L1: int, L2: int, draws: tuple) -> tuple:
    """Build a delayed tree from explicit token draws; returns (tree, prob)."""
    tokens = [-1]
    parent = [-1]
    depth = [0]
    pid = [0]
    qs = [model.q(())]
    prob = 1.0
    it = iter(draws)
    ctx: tuple = ()
    node = 0
    for _ in range(L1):
        t = next(it)
        prob *= float(qs[node][t])
        ctx = ctx + (t,)
        tokens.append(t)
        parent.append(node)
        depth.append(depth[node] + 1)
        pid.append(0)
        qs.append(model.q(ctx))
        node = len(tokens) - 1
    bnode, bctx = node, ctx
    for k in range(K):
        node, ctx = bnode, bctx
        for _ in range(L2):
            t = next(it)
            prob *= float(qs[node][t])
            ctx = ctx + (t,)
            tokens.append(t)
            parent.append(node)
            depth.append(depth[node] + 1)
            pid.append(k)
            qs.append(model.q(ctx))
            node = len(tokens) - 1
    tree = DraftTree(
        tokens=np.asarray(tokens, dtype=np.int64),
        parent=np.asarray(parent, dtype=np.int64),
        depth=np.asarray(depth, dtype=np.int64),
        q=np.stack(qs),
        path_id=np.asarray(pid, dtype=np.int64),
    )
    attach_target(tree, model.p)
    return tree, prob


def iter_trees(model: RandomModel, K: int, L1: int, L2: int):
    n_draws = L1 + K * L2
    for draws in itertools.product(range(model.vocab), repeat=n_draws):
        tree, prob = build_tree_from_draws(model, K, L1, L2, draws)
        if prob > 0:
            yield tree, prob


def expected_block_dist(dist_fn, model: RandomModel, K: int, L1: int, L2: int) -> dict:
    """E over trees of the verifier's exact conditional block distribution."""
    agg: dict = {}
    for tree, prob in iter_trees(model, K, L1, L2):
        d = dist_fn(tree)
        for blk, m in d.items():
            agg[blk] = agg.get(blk, 0.0) + prob * m
    return agg


def lossless_gap(block_dist: dict, model: RandomModel, max_len: int) -> float:
    """Max |G(y) - P_target(y)| over all strings up to max_len."""

    def target_prob(y):
        pr = 1.0
        for i, t in enumerate(y):
            pr *= float(model.p(y[:i])[t])
        return pr

    worst = 0.0
    for n in range(1, max_len + 1):
        for y in itertools.product(range(model.vocab), repeat=n):
            g = 0.0
            # blocks that are strict prefixes of y, extended by target
            for m in range(1, n):
                blk = y[:m]
                if blk in block_dist:
                    ext = 1.0
                    for i in range(m, n):
                        ext *= float(model.p(y[:i])[y[i]])
                    g += block_dist[blk] * ext
            # blocks that contain y as a prefix
            for blk, mass in block_dist.items():
                if len(blk) >= n and blk[:n] == y:
                    g += mass
            worst = max(worst, abs(g - target_prob(y)))
    return worst


def mean_block_len(block_dist: dict) -> float:
    return sum(len(b) * m for b, m in block_dist.items())
