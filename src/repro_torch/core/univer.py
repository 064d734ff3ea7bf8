"""UniVer — unified multi-step x multi-draft verification (arXiv 2605.04543).

The retrieval pins UniVer down only by its properties (one verifier unifying
Block Verification's multi-step nested-weight coupling with SpecInfer's
multi-draft OT coupling; reduces to BV at K=1 and to SpecInfer at L1=0,
L2=1), so — as with traversal.py — the scheme is derived from first
principles and proven lossless by exact enumeration (tests/test_lossless.py).

Construction: walk the tree top-down over active sets (merged-context
multiset semantics, Def. 3.1).  At each point the child multiset of the
active set picks the coupling:

* multiset size >= 2 — one SpecInfer OT step on (p, q, child tokens): the
  residual-corrected multi-draft coupling emits either a drafted child
  (recurse into its match set) or a correction token (the block ends).
* multiset size == 1 — a *segment*: the maximal unary chain ahead is
  verified as one BV block with nested weights  w_0 = 1,
  w_i = min(1, w_{i-1} p_i(x_i)/q_i(x_i))  and the conditional leaf-to-root
  climb of traversal.py.  Accepting depth i < L emits the chain prefix plus
  a correction ~ norm((w_i p_{i+1} - q_{i+1})_+); full rejection emits
  norm((p_1 - q_1)_+); full acceptance *continues the walk* at the segment
  end — the next stage replaces BV's terminal p_{L+1} sample.
* empty multiset — leaf: emit a fresh target sample and stop.

Losslessness: each stage is a lossless block coupling given its reach event,
and a stage's randomness is independent of deeper draft draws, so the
composite is lossless by the induction of core/enumerate.py (a lossless
continuation contributes to the G-criterion exactly like a target sample
followed by target continuation).  On a delayed (K, L1, L2) tree the trunk
is one segment, the branch root is a SpecInfer step over the K branch heads,
and surviving match sets decay into segments — hence both reductions hold
by construction.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.otlp import OTLP_SOLVERS, _norm, _pos
from repro_torch.core.traversal import _EPS, _climb_masses, _pq, _segment_correction, _tok, _trunk_weights
from repro_torch.core.trees import DraftTree


def _segment(tree: DraftTree, active: list[int]) -> list[int]:
    """Maximal unary chain ahead of ``active`` (levels whose child multiset
    has exactly one element)."""
    seg: list[int] = []
    a = list(active)
    while True:
        kids = tree.children_of_set(a)
        if len(kids) != 1:
            return seg
        seg.append(kids[0])
        a = kids


def verify_univer(tree: DraftTree, rng: np.random.Generator):
    """Sample the UniVer verifier.  Returns (accepted_tokens, correction)."""
    assert tree.p is not None, "attach_target first"
    solve, _, _ = OTLP_SOLVERS["specinfer"]
    active = [0]
    accepted: list[int] = []
    while True:
        kids = tree.children_of_set(active)
        node = active[0]
        p, q = _pq(tree, node)
        if not kids:  # leaf: fresh target sample
            return accepted, int(rng.choice(tree.vocab, p=_norm(p)))
        if len(kids) >= 2:  # SpecInfer OT step on the child multiset
            xs = [_tok(tree, c) for c in kids]
            y = int(solve(p, q, xs, rng))
            matches = [c for c in kids if _tok(tree, c) == y]
            if not matches:
                return accepted, y
            accepted.append(y)
            active = matches
            continue
        # BV segment over the maximal unary chain
        seg = _segment(tree, active)
        vs = _trunk_weights(tree, seg)
        masses, surv = _climb_masses(tree, seg, vs)
        u = rng.random()
        csum, tau = 0.0, 0
        for j in range(len(seg), 0, -1):
            csum += masses[j - 1]
            if u < csum:
                tau = j
                break
        if tau == len(seg):  # full acceptance: continue at the segment end
            accepted.extend(_tok(tree, v) for v in seg)
            active = [seg[-1]]
            continue
        if tau:
            accepted.extend(_tok(tree, v) for v in seg[:tau])
            corr = int(rng.choice(tree.vocab, p=_segment_correction(tree, seg, vs, tau)))
            return accepted, corr
        resid = _pos(p - q)
        if resid.sum() <= _EPS:  # p == q: full rejection has measure zero
            resid = p
        return accepted, int(rng.choice(tree.vocab, p=_norm(resid)))


def univer_output_dist(tree: DraftTree) -> dict:
    """Exact emitted-block distribution of UniVer conditioned on the tree."""
    assert tree.p is not None
    _, specinfer_dist, _ = OTLP_SOLVERS["specinfer"]
    out: dict = {}

    def add(prefix: tuple, dist, mass: float):
        if mass <= 0:
            return
        for t, pt in enumerate(dist):
            if pt > 0:
                key = prefix + (t,)
                out[key] = out.get(key, 0.0) + mass * float(pt)

    def rec(active: list[int], prefix: tuple, mass: float):
        if mass <= 0:
            return
        kids = tree.children_of_set(active)
        node = active[0]
        p, q = _pq(tree, node)
        if not kids:
            add(prefix, _norm(p), mass)
            return
        if len(kids) >= 2:
            xs = [_tok(tree, c) for c in kids]
            d = specinfer_dist(p, q, xs)
            xs_set = set(xs)
            for t, dt in enumerate(d):
                if dt <= 0:
                    continue
                if t in xs_set:
                    rec([c for c in kids if _tok(tree, c) == t], prefix + (t,), mass * float(dt))
                else:
                    key = prefix + (t,)
                    out[key] = out.get(key, 0.0) + mass * float(dt)
            return
        seg = _segment(tree, active)
        vs = _trunk_weights(tree, seg)
        masses, surv = _climb_masses(tree, seg, vs)
        toks = tuple(_tok(tree, v) for v in seg)
        for j in range(1, len(seg)):
            add(prefix + toks[:j], _segment_correction(tree, seg, vs, j), mass * float(masses[j - 1]))
        rec([seg[-1]], prefix + toks, mass * float(masses[-1]))
        if surv > 0:
            resid = _pos(p - q)
            if resid.sum() > _EPS:
                add(prefix, _norm(resid), mass * float(surv))

    rec([0], (), 1.0)
    return out
