"""Delayed tree expansion (Sec. 5): drafting policy + block-efficiency
estimation via branching probabilities (Def. 5.3, Eq. 3).

For an OT-based verifier, conditioned on a drafted tree T:

    E[tau + 1 | T] = sum_{c' in T} P(solver reaches c' | T)
                   = sum_{paths} prod_j B(f, ch(...), t_j)            (Eq. 3)

computed exactly from the solver's branching probabilities.  The outer
expectation over trees is estimated with ``s`` i.i.d. delayed-tree samples
(the paper uses s = 4): unbiased, and free of verification variance.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.otlp import OTLP_SOLVERS
from repro_torch.core.trees import DraftTree, attach_target, build_delayed_tree


def expected_block_efficiency(tree: DraftTree, solver: str) -> float:
    """Eq. 3 inner sum: exact E[tau + 1 | tree] for an OT-based verifier."""
    assert tree.p is not None
    _, output_dist, _ = OTLP_SOLVERS[solver]

    total = 0.0

    def rec(active: list[int], reach: float):
        nonlocal total
        total += reach  # counts this context (root contributes the +1)
        kids = tree.children_of_set(active)
        if not kids:
            return
        node = active[0]
        d = output_dist(tree.p[node], tree.q[node], [int(tree.tokens[c]) for c in kids])
        for t in {int(tree.tokens[c]) for c in kids}:
            b = float(d[t])
            if b > 0:
                rec([c for c in kids if int(tree.tokens[c]) == t], reach * b)

    rec([0], 1.0)
    return total


def expected_block_efficiency_dist(tree: DraftTree, verifier: str) -> float:
    """E[tau + 1 | tree] for ANY registered verifier, from its exact
    conditional block law (core/verify.py registry).  The OT family also has
    the cheaper Eq. 3 recursion above; this is the generic path."""
    from repro_torch.core.verify import get_verifier

    d = get_verifier(verifier).output_dist(tree)
    return sum(len(blk) * m for blk, m in d.items())


def expected_block_efficiency_traversal(tree: DraftTree) -> float:
    """E[tau + 1 | tree] for Traversal (from its exact conditional law)."""
    return expected_block_efficiency_dist(tree, "traversal")


def estimate_block_efficiency(
    rng: np.random.Generator,
    q_fn,
    p_fn,
    solver: str,
    K: int,
    L1: int,
    L2: int,
    context: tuple = (),
    s: int = 4,
) -> float:
    """Outer expectation of Eq. 3 over ``s`` i.i.d. delayed-tree samples.

    ``solver`` is any registered verifier name: the OT family goes through
    the Eq. 3 branching recursion, everything else through its exact
    conditional block law — so selector oracles (analytic_best_action, NDE
    labelling) work for the whole verifier zoo."""
    from repro_torch.core.verify import get_verifier

    spec = get_verifier(solver)
    vals = []
    for _ in range(s):
        tree = build_delayed_tree(rng, q_fn, K, L1, L2, root_context=context)
        attach_target(tree, p_fn, root_context=context)
        if spec.on_device:  # top-down OT: exact Eq. 3 branching recursion
            vals.append(expected_block_efficiency(tree, solver))
        else:
            vals.append(expected_block_efficiency_dist(tree, solver))
    return float(np.mean(vals))


# ------------------------------------------------- Fig. 1 style analysis -----


def acceptance_by_depth(tree: DraftTree, solver: str, k: int) -> list[tuple[int, float]]:
    """Per-node (depth, acceptance rate alpha(f_{p,q,k})) — Def. 5.1."""
    assert tree.p is not None
    _, _, acc = OTLP_SOLVERS[solver]
    out = []
    for i in range(tree.n_nodes):
        out.append((int(tree.depth[i]), acc(tree.p[i], tree.q[i], k)))
    return out


def l1_by_depth(tree: DraftTree) -> list[tuple[int, float]]:
    """Per-node (depth, ||p - q||_1) — the divergence signal of Fig. 1."""
    assert tree.p is not None
    return [
        (int(tree.depth[i]), float(np.abs(tree.p[i] - tree.q[i]).sum()))
        for i in range(tree.n_nodes)
    ]


# ------------------------------------------ latency model (Eq. 11, App. E) ---


class LatencyModel:
    """Wall-clock model of draft/target forward passes.

    t_q(l), t_p(l): seconds for a forward pass at context length l.  On the
    card they are fitted by least squares to timed passes (chip_smoke.py
    phase 6); the tests set them synthetically.  The affine form a + b*l
    captures the memory-bound decode regime (weights read + KV read).
    """

    def __init__(self, t_q_base: float, t_q_per_tok: float, t_p_base: float, t_p_per_tok: float,
                 t_p_per_tree_tok: float = 0.0):
        self.t_q_base = t_q_base
        self.t_q_per_tok = t_q_per_tok
        self.t_p_base = t_p_base
        self.t_p_per_tok = t_p_per_tok
        # marginal cost of one extra speculation token in the batched target
        # pass.  Eq. 11 as printed prices the tree only through the context-
        # length term, making large trees nearly free; the term is fitted
        # on the card beside the others.
        self.t_p_per_tree_tok = t_p_per_tree_tok

    def t_q(self, l) -> float:
        return self.t_q_base + self.t_q_per_tok * float(l)

    def t_p(self, l) -> float:
        return self.t_p_base + self.t_p_per_tok * float(l)

    def action_time(self, ctx_len: int, K: int, L1: int, L2: int) -> float:
        """Eq. 11: trunk drafting + branch drafting + one target tree pass."""
        t = 0.0
        for j in range(L1):
            t += self.t_q(ctx_len + j)
        for j in range(L2):
            t += self.t_q(ctx_len + L1 + j * K)
        t += self.t_p(ctx_len + L1 + K * L2)
        t += self.t_p_per_tree_tok * (L1 + K * L2)
        return t


def analytic_best_action(
    rng: np.random.Generator,
    q_fn,
    p_fn,
    solver: str,
    latency: LatencyModel,
    ctx: tuple,
    K_max: int = 4,
    L1_max: int = 8,
    L2_max: int = 8,
    s: int = 1,
    actions=None,
) -> tuple:
    """Beyond-paper: exhaustively maximise Ê[tau+1]/T̂ over the action space
    using the exact Eq. 3 estimator (the paper instead trains an MLP on
    offline traces; this oracle is also used to label its training data)."""
    best, best_tps = None, -1.0
    if actions is None:
        actions = [
            (K, L1, L2)
            for K in range(1, K_max + 1)
            for L1 in range(L1_max + 1)
            for L2 in range(L2_max + 1)
            if L1 + L2 > 0 and not (K > 1 and L2 == 0)
        ]
    for K, L1, L2 in actions:
        be = estimate_block_efficiency(rng, q_fn, p_fn, solver, K, L1, L2, context=ctx, s=s)
        tps = be / latency.action_time(len(ctx), K, L1, L2)
        if tps > best_tps:
            best, best_tps = (K, L1, L2), tps
    return best, best_tps
