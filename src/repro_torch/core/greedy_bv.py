"""Greedy Multi-Path Block Verification (arXiv 2602.16961).

The retrieval pins the scheme down only by its properties (greedy path
selection with BV-style nested weights per path; multi-path generalisation
of Block Verification; lossless), so — as with traversal.py — it is derived
from first principles and proven lossless by exact enumeration
(tests/test_lossless.py).

Greedy selection.  Walk the tree level by level, always descending into the
drafted child token with the highest target/draft ratio p(t)/q(t) (ties:
smaller token id).  The m multiset children at a level are i.i.d. draft
draws, so the selected token's conditional law has the closed form

    g(t) = W_t^m - (W_t - q(t))^m,
    W_t  = sum of q(s) over tokens s not strictly better than t,

the max-order-statistic law of the greedy rule under the strict total order
(ratio, -token).  The greedily-selected path is therefore a draw from a
*known adapted proposal process* with per-step conditionals g_i — and
single-path Block Verification applies verbatim with q_i replaced by g_i:

    w_0 = 1,  w_i = min(1, w_{i-1} p_i(t_i) / g_i(t_i)),

realised through the conditional leaf-to-root climb of traversal.py
(e_{i+1} = sum_s min(w_i p(s), g_{i+1}(s))), with corrections

    depth i < L:  norm((w_i p_{i+1} - g_{i+1})_+)
    depth L:      p(.|leaf)            root:  norm((p_1 - g_1)_+).

Adaptedness is what makes the greedy order sound: the multiset size m_i is
a function of shallower draws only, and conditional on it the level's draws
are fresh i.i.d. q — so g_i is exactly the conditional law of the winner
given everything the verifier has used so far.  (A greedy order with the
*unadjusted* q-ratios is provably biased: for p=(.6,.4), q=(.5,.5), K=2 it
emits token 0 with probability .75 instead of .6.)

At K=1 every level has m=1, g == q, and the scheme is exactly Block
Verification; at L1=0, L2=1 it is the greedy one-step multi-draft coupling.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.otlp import _norm, _pos
from repro_torch.core.traversal import _EPS, _pq, _tok
from repro_torch.core.trees import DraftTree


def _winner_law(p: np.ndarray, q: np.ndarray, xs: list[int]):
    """Greedy winner of the drafted multiset ``xs`` (m i.i.d. q-draws) and
    the exact law of that winner over the vocab."""
    m = len(xs)
    ratio = np.where(q > 0, p / np.maximum(q, _EPS), -np.inf)
    order = sorted(np.flatnonzero(q > 0).tolist(), key=lambda t: (ratio[t], -t))
    g = np.zeros_like(q)
    w_cum = 0.0
    for t in order:  # ascending: worst token first
        w_cum += float(q[t])
        g[t] = w_cum**m - (w_cum - float(q[t])) ** m
    t_star = max(set(xs), key=lambda t: (ratio[t], -t))
    return int(t_star), g


def _greedy_chain(tree: DraftTree):
    """Deterministic greedy walk.  Returns (nodes, gs, ws): representative
    winner node, winner law, and nested weight per level."""
    active = [0]
    nodes: list[int] = []
    gs: list[np.ndarray] = []
    ws: list[float] = []
    w = 1.0
    while True:
        kids = tree.children_of_set(active)
        if not kids:
            return nodes, gs, ws
        node = active[0]
        p, q = _pq(tree, node)
        xs = [_tok(tree, c) for c in kids]
        t_star, g = _winner_law(p, q, xs)
        w = min(1.0, w * float(p[t_star]) / max(float(g[t_star]), _EPS))
        nodes.append([c for c in kids if _tok(tree, c) == t_star][0])
        gs.append(g)
        ws.append(w)
        active = [c for c in kids if _tok(tree, c) == t_star]


def _greedy_climb(tree: DraftTree, nodes, gs, ws):
    """Conditional leaf-to-root climb over the greedy chain; returns
    (masses, reject_prob) exactly as traversal._climb_masses but against the
    winner laws g instead of q."""
    L = len(nodes)
    alphas = np.zeros(L)
    alphas[L - 1] = ws[L - 1]
    for j in range(L - 1, 0, -1):
        p, _ = _pq(tree, nodes[j - 1])
        e = float(np.sum(np.minimum(ws[j - 1] * p, gs[j])))
        a = (ws[j - 1] - e) / max(1.0 - e, _EPS) if e < 1.0 else 0.0
        alphas[j - 1] = min(max(a, 0.0), 1.0)
    masses = np.zeros(L)
    surv = 1.0
    for j in range(L, 0, -1):
        masses[j - 1] = surv * alphas[j - 1]
        surv *= 1.0 - alphas[j - 1]
    return masses, surv


def _greedy_correction(tree: DraftTree, nodes, gs, ws, j: int) -> np.ndarray:
    """Correction distribution on accepting depth j (1-indexed)."""
    p, _ = _pq(tree, nodes[j - 1])
    if j == len(nodes):
        return _norm(p)
    return _norm(_pos(ws[j - 1] * p - gs[j]))


def _root_correction(tree: DraftTree, gs) -> np.ndarray:
    p0, _ = _pq(tree, 0)
    resid = _pos(p0 - gs[0])
    if resid.sum() <= _EPS:  # p == g: full rejection has measure zero
        resid = p0
    return _norm(resid)


def verify_greedy_mpbv(tree: DraftTree, rng: np.random.Generator):
    """Sample the greedy multi-path BV verifier.  Returns
    (accepted_tokens, correction)."""
    assert tree.p is not None, "attach_target first"
    nodes, gs, ws = _greedy_chain(tree)
    if not nodes:
        p0, _ = _pq(tree, 0)
        return [], int(rng.choice(tree.vocab, p=_norm(p0)))
    masses, _ = _greedy_climb(tree, nodes, gs, ws)
    u = rng.random()
    csum = 0.0
    for j in range(len(nodes), 0, -1):
        csum += masses[j - 1]
        if u < csum:
            corr = int(rng.choice(tree.vocab, p=_greedy_correction(tree, nodes, gs, ws, j)))
            return tree.path_tokens(nodes[j - 1]), corr
    return [], int(rng.choice(tree.vocab, p=_root_correction(tree, gs)))


def greedy_mpbv_output_dist(tree: DraftTree) -> dict:
    """Exact emitted-block distribution conditioned on the drafted tree
    (the greedy chain is deterministic given the tree)."""
    assert tree.p is not None
    nodes, gs, ws = _greedy_chain(tree)
    out: dict = {}

    def add(prefix, dist, mass):
        if mass <= 0:
            return
        for t, pt in enumerate(dist):
            if pt > 0:
                key = tuple(prefix) + (t,)
                out[key] = out.get(key, 0.0) + mass * float(pt)

    if not nodes:
        p0, _ = _pq(tree, 0)
        add([], _norm(p0), 1.0)
        return out
    masses, surv = _greedy_climb(tree, nodes, gs, ws)
    for j in range(len(nodes), 0, -1):
        add(tree.path_tokens(nodes[j - 1]), _greedy_correction(tree, nodes, gs, ws, j),
            float(masses[j - 1]))
    if surv > 0:
        add([], _root_correction(tree, gs), float(surv))
    return out
