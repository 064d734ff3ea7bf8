"""Traversal Verification — bottom-up tree verification (Weng et al., 2025).

The paper under reproduction specifies Traversal only by its properties (the
sole bottom-up multi-path verifier; reduces to Block Verification at K=1), so
we derive the scheme from first principles for delayed trees (Def. 5.2, which
subsume i.i.d. root rollouts at L1=0) and prove it lossless by exact
enumeration (tests/test_lossless.py).  Construction:

Trunk:  nested block weights  w_0 = 1, w_i = min(1, w_{i-1} p_i(t_i)/q_i(t_i)),
        W = w_{L1}.

Branch stage (leaf-first, branches in drafted order):  maintain the
*unnormalised residual target measure* mu at the branch node, initialised to
mu_1 = W * p(.|branch ctx)  (mass W), and the reach probability rho_1 = 1.
For branch k with tokens s_1..s_{L2}:

    v_1 = min(1, mu_k(s_1) / (rho_k q_b(s_1)))          [first-step weight]
    v_j = min(1, v_{j-1} p_j(s_j)/q_j(s_j))             [deeper, fresh target]

    climb from the leaf with *conditional* acceptances
        alpha_{L2} = v_{L2}
        alpha_j    = (v_j - e_{j+1}) / (1 - e_{j+1}),
        e_{j+1}    = sum_s min(v_j p(s|node_j), q(s|node_j))
    accepting depth j emits the whole root path (trunk + branch prefix) with
    correction  ~ p(.|leaf)                       if j = L2
               ~ norm((v_j p(.|node_j) - q(.|node_j))_+)   otherwise.

    On full rejection:  a_k = sum_s min(mu_k(s)/rho_k, q_b(s)),
        mu_{k+1} = (mu_k - rho_k q_b)_+ ,   rho_{k+1} = rho_k (1 - a_k).

Trunk stage (after all branches reject):  alpha_{L1} = mass(mu_{K+1})/rho_{K+1}
with correction norm(mu_{K+1}); deeper trunk levels climb with the standard
conditional weights (e_i as above), corrections norm((w_i p - q)_+), and the
root correction is norm((p - q)_+).

At K=1 every quantity collapses to Block Verification on the full path; at
L1=0, L2=1 the branch stage is exactly (ordered) SpecInfer.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.otlp import _norm, _pos
from repro_torch.core.trees import DraftTree

_EPS = 1e-300


# --------------------------------------------------------------- structure ---


def delayed_structure(tree: DraftTree):
    """Decompose into (trunk_nodes, branch_root, [branch_paths]) using path_id
    when available (needed to find the L1 boundary of K=1 trees)."""
    if tree.path_id is not None:
        # trunk nodes: path_id == 0 nodes that are ancestors of all leaves —
        # identify branch root as deepest node lying on every drafted path.
        # For delayed trees built by this framework: trunk = nodes whose
        # subtree contains every leaf.
        n = tree.n_nodes
        kids_of = [[] for _ in range(n)]
        for i in range(1, n):
            kids_of[int(tree.parent[i])].append(i)
        # count leaves under each node
        leaves_under = [0] * n
        order = sorted(range(n), key=lambda i: -int(tree.depth[i]))
        total_leaves = 0
        for i in order:
            if not kids_of[i]:
                leaves_under[i] = 1
            else:
                leaves_under[i] = sum(leaves_under[c] for c in kids_of[i])
        total_leaves = leaves_under[0]
        trunk = []
        node = 0
        while kids_of[node]:
            on_all = [c for c in kids_of[node] if leaves_under[c] == total_leaves]
            if len(kids_of[node]) == 1 and on_all:
                # unique child containing all leaves: still trunk *unless* the
                # path structure says branching starts here (K=1 delayed tree)
                c = on_all[0]
                # branch nodes of path k>0 never sit on the trunk; for K=1 we
                # cannot distinguish — treat the whole chain as trunk + use
                # n_branch hints from metadata when present.
                trunk.append(c)
                node = c
            else:
                break
        branch_root = node
    else:
        trunk = []
        node = 0
        while True:
            kids = tree.children(node)
            if len(kids) != 1:
                break
            trunk.append(kids[0])
            node = kids[0]
        branch_root = node
    branches = []
    for c in tree.children(branch_root):
        if c in trunk:
            continue
        path = [c]
        cur = c
        while True:
            k2 = tree.children(cur)
            if not k2:
                break
            assert len(k2) == 1, "delayed-tree branches must be simple paths"
            cur = k2[0]
            path.append(cur)
        branches.append(path)
    return trunk, branch_root, branches


def _tok(tree, v):
    return int(tree.tokens[v])


def _pq(tree, node):
    return (
        np.asarray(tree.p[node], dtype=np.float64),
        np.asarray(tree.q[node], dtype=np.float64),
    )


def _trunk_weights(tree, trunk):
    w, out = 1.0, []
    for v in trunk:
        p, q = _pq(tree, int(tree.parent[v]))
        t = _tok(tree, v)
        w = min(1.0, w * p[t] / max(q[t], _EPS))
        out.append(w)
    return np.asarray(out)


def _branch_weights(tree, path, v1):
    out = [v1]
    v = v1
    for node in path[1:]:
        p, q = _pq(tree, int(tree.parent[node]))
        t = _tok(tree, node)
        v = min(1.0, v * p[t] / max(q[t], _EPS))
        out.append(v)
    return np.asarray(out)


def _climb_masses(tree, path, vs):
    """P(accept depth j | segment reached), j = 1..len(path); conditional
    leaf-to-root climb.  Returns (masses, reject_prob)."""
    L = len(path)
    alphas = np.zeros(L)
    alphas[L - 1] = vs[L - 1]
    for j in range(L - 1, 0, -1):  # depth j (1-indexed), node path[j-1]
        node = path[j - 1]
        p, q = _pq(tree, node)
        e = float(np.sum(np.minimum(vs[j - 1] * p, q)))
        alphas[j - 1] = (vs[j - 1] - e) / max(1.0 - e, _EPS) if e < 1.0 else 0.0
        alphas[j - 1] = min(max(alphas[j - 1], 0.0), 1.0)
    masses = np.zeros(L)
    surv = 1.0
    for j in range(L, 0, -1):
        masses[j - 1] = surv * alphas[j - 1]
        surv *= 1.0 - alphas[j - 1]
    return masses, surv


def _segment_correction(tree, path, vs, j):
    """Correction distribution on accepting depth j (1-indexed) of a path."""
    node = path[j - 1]
    p, q = _pq(tree, node)
    if j == len(path):
        return _norm(p)
    return _norm(_pos(vs[j - 1] * p - q))


def verify_traversal(tree: DraftTree, rng: np.random.Generator):
    """Sample the Traversal verifier.  Returns (accepted_tokens, correction)."""
    assert tree.p is not None
    trunk, broot, branches = delayed_structure(tree)
    tw = _trunk_weights(tree, trunk)
    W = float(tw[-1]) if len(tw) else 1.0
    pb, qb = _pq(tree, broot)

    mu = W * pb  # unnormalised residual measure at the branch node
    rho = 1.0
    for path in branches:
        t1 = _tok(tree, path[0])
        v1 = min(1.0, mu[t1] / max(rho * qb[t1], _EPS))
        vs = _branch_weights(tree, path, v1)
        masses, rej = _climb_masses(tree, path, vs)
        u = rng.random()
        csum = 0.0
        accepted_j = 0
        # climb leaf-to-root: realise the conditional Bernoullis via masses
        for j in range(len(path), 0, -1):
            csum += masses[j - 1]
            if u < csum:
                accepted_j = j
                break
        if accepted_j:
            node = path[accepted_j - 1]
            corr = int(rng.choice(tree.vocab, p=_segment_correction(tree, path, vs, accepted_j)))
            return tree.path_tokens(node), corr
        a_k = float(np.sum(np.minimum(mu / max(rho, _EPS), qb)))
        mu = _pos(mu - rho * qb)
        rho *= 1.0 - a_k
    # trunk stage
    mass_mu = float(mu.sum())
    if trunk:
        alpha_top = min(1.0, mass_mu / max(rho, _EPS))
        if rng.random() <= alpha_top:
            corr = int(rng.choice(tree.vocab, p=_norm(mu)))
            return tree.path_tokens(trunk[-1]), corr
        # climb remaining trunk with standard conditional weights
        tws = np.concatenate([[1.0], tw])
        for j in range(len(trunk) - 1, 0, -1):
            node = trunk[j - 1]
            p, q = _pq(tree, node)
            e = float(np.sum(np.minimum(tws[j] * p, q)))
            alpha = (tws[j] - e) / max(1.0 - e, _EPS) if e < 1.0 else 0.0
            if rng.random() <= min(max(alpha, 0.0), 1.0):
                corr = int(rng.choice(tree.vocab, p=_norm(_pos(tws[j] * p - q))))
                return tree.path_tokens(node), corr
        p0, q0 = _pq(tree, 0)
        return [], int(rng.choice(tree.vocab, p=_norm(_pos(p0 - q0))))
    # L1 == 0: no trunk; emit root correction from the residual measure
    return [], int(rng.choice(tree.vocab, p=_norm(mu) if mass_mu > 0 else _norm(_pos(pb - qb))))


def verify_traversal_output_dist(tree: DraftTree) -> dict:
    """Exact emitted-block distribution conditioned on the drafted tree."""
    assert tree.p is not None
    trunk, broot, branches = delayed_structure(tree)
    tw = _trunk_weights(tree, trunk)
    W = float(tw[-1]) if len(tw) else 1.0
    pb, qb = _pq(tree, broot)
    out: dict = {}

    def add(prefix, dist, mass):
        if mass <= 0:
            return
        for t, pt in enumerate(dist):
            if pt > 0:
                key = tuple(prefix) + (t,)
                out[key] = out.get(key, 0.0) + mass * float(pt)

    mu = W * pb
    rho = 1.0
    reach = 1.0  # P(branch stage reaches branch k)
    for path in branches:
        t1 = _tok(tree, path[0])
        v1 = min(1.0, mu[t1] / max(rho * qb[t1], _EPS))
        vs = _branch_weights(tree, path, v1)
        masses, rej = _climb_masses(tree, path, vs)
        for j in range(len(path), 0, -1):
            node = path[j - 1]
            add(tree.path_tokens(node), _segment_correction(tree, path, vs, j), reach * masses[j - 1])
        reach *= rej
        a_k = float(np.sum(np.minimum(mu / max(rho, _EPS), qb)))
        mu = _pos(mu - rho * qb)
        rho *= 1.0 - a_k
    mass_mu = float(mu.sum())
    if trunk:
        alpha_top = min(1.0, mass_mu / max(rho, _EPS))
        add(tree.path_tokens(trunk[-1]), _norm(mu), reach * alpha_top)
        surv = reach * (1.0 - alpha_top)
        tws = np.concatenate([[1.0], tw])
        for j in range(len(trunk) - 1, 0, -1):
            node = trunk[j - 1]
            p, q = _pq(tree, node)
            e = float(np.sum(np.minimum(tws[j] * p, q)))
            alpha = min(max((tws[j] - e) / max(1.0 - e, _EPS) if e < 1.0 else 0.0, 0.0), 1.0)
            add(tree.path_tokens(node), _norm(_pos(tws[j] * p - q)), surv * alpha)
            surv *= 1.0 - alpha
        p0, q0 = _pq(tree, 0)
        add([], _norm(_pos(p0 - q0)), surv)
    else:
        if mass_mu > 0:
            add([], mu / mass_mu, reach)
        else:
            add([], _norm(_pos(pb - qb)), reach)
    return out
