"""OTLP solvers (Def. 3.2) — Appendix B of the paper — plus their exact
conditional output distributions (Appendix D generalised to the whole vocab)
and acceptance rates (Appendix C).

For each solver ``name`` we provide:

  ``<name>_solve(p, q, xs, rng)``       -> sampled output token (host, exact)
  ``<name>_output_dist(p, q, xs)``      -> (V,) exact distribution of the output
                                           *conditioned on the draft tokens xs*
  ``<name>_acceptance(p, q, k)``        -> P(output in {X_1..X_k}), X_i iid ~ q

Branching probabilities (Def. 5.3 / Appendix D) are ``output_dist[xs]``.

Losslessness (the OTLP property)  E_{xs ~ q^k}[output_dist(p,q,xs)] == p
is verified by exact enumeration in the tests.

Host-side numpy in float64: these functions are the *oracle* layer.  The
serving engine uses the jittable versions in ``repro.core.otlp_jax`` which are
tested against these.
"""
from __future__ import annotations

import numpy as np

_EPS = 1e-300


def _norm(v: np.ndarray) -> np.ndarray:
    s = v.sum()
    if s <= 0:
        # degenerate residual: caller guarantees it is weighted by 0 mass.
        out = np.zeros_like(v)
        out[0] = 1.0
        return out
    return v / s


def _pos(v: np.ndarray) -> np.ndarray:
    return np.maximum(v, 0.0)


# ---------------------------------------------------------------- NSS --------


def nss_output_dist(p, q, xs):
    return np.asarray(p, dtype=np.float64).copy()


def nss_solve(p, q, xs, rng):
    return int(rng.choice(len(p), p=_norm(np.asarray(p, dtype=np.float64))))


def nss_acceptance(p, q, k):
    return float(np.sum(p * (1.0 - (1.0 - q) ** k)))


# --------------------------------------------------------------- Naive -------


def naive_output_dist(p, q, xs):
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    x1 = int(xs[0])
    a = min(1.0, p[x1] / max(q[x1], _EPS))
    res = _norm(_pos(p - q))
    out = (1.0 - a) * res
    out[x1] += a
    return out


def naive_solve(p, q, xs, rng):
    x1 = int(xs[0])
    if rng.random() <= min(1.0, p[x1] / max(q[x1], _EPS)):
        return x1
    return int(rng.choice(len(p), p=_norm(_pos(np.asarray(p) - np.asarray(q)))))


def naive_acceptance(p, q, k):
    # Alg. 7: accept X1 naively; otherwise the residual may still land on one
    # of the other k-1 iid draft tokens.
    acc1 = float(np.sum(np.minimum(p, q)))
    res = _pos(p - q)  # unnormalised residual has mass 1 - acc1
    return acc1 + float(np.sum(res * (1.0 - (1.0 - q) ** (k - 1))))


# -------------------------------------------------------------- SpecTr -------


def _spectr_rho(p, q, k) -> float:
    """Binary search the division factor rho* on [1, k] (K-SEQ)."""

    def beta(rho):
        return float(np.sum(np.minimum(p / rho, q)))

    def g(rho):  # p_acc(rho) - rho * beta(rho), monotone decreasing
        b = beta(rho)
        return (1.0 - (1.0 - b) ** k) - rho * b

    if k == 1:
        return 1.0
    lo, hi = 1.0, float(k)
    if g(lo) <= 0:
        return lo
    if g(hi) >= 0:
        return hi
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if g(mid) > 0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _spectr_parts(p, q, k):
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    rho = _spectr_rho(p, q, k)
    cap = np.minimum(p / rho, q)  # per-token accepted mass (one round)
    beta = float(cap.sum())
    p_acc = 1.0 - (1.0 - beta) ** k
    gamma = p_acc / beta if beta > 0 else 0.0
    res = _norm(_pos(p - cap * gamma))
    return rho, cap, beta, p_acc, gamma, res


def spectr_output_dist(p, q, xs):
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    k = len(xs)
    rho, cap, beta, p_acc, gamma, res = _spectr_parts(p, q, k)
    a = np.array([min(1.0, p[x] / (rho * max(q[x], _EPS))) for x in xs])
    out = np.zeros_like(p)
    fail = 1.0
    for i, x in enumerate(xs):
        out[int(x)] += fail * a[i]
        fail *= 1.0 - a[i]
    out += fail * res
    return out


def spectr_solve(p, q, xs, rng):
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    rho, cap, beta, p_acc, gamma, res = _spectr_parts(p, q, len(xs))
    for x in xs:
        if rho * rng.random() <= p[int(x)] / max(q[int(x)], _EPS):
            return int(x)
    return int(rng.choice(len(p), p=res))


def spectr_acceptance(p, q, k):
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    rho, cap, beta, p_acc, gamma, res = _spectr_parts(p, q, k)
    r = _pos(q - p / rho) / max(1.0 - beta, _EPS)
    return p_acc + (1.0 - p_acc) * float(np.sum(res * (1.0 - (1.0 - r) ** k)))


# ----------------------------------------------------------- SpecInfer -------


def _specinfer_rounds(p, q, k):
    """Residuals p_0..p_k and accept vectors a_1..a_k (a_i = min(1, p_{i-1}/q))."""
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    ps = [p]
    avs = []
    cur = p
    for _ in range(k):
        avs.append(np.minimum(1.0, cur / np.maximum(q, _EPS)))
        cur = _norm(_pos(cur - q))
        ps.append(cur)
    return ps, avs


def specinfer_output_dist(p, q, xs):
    """Exact Alg. 14 recursion over sub-multisets of the draft tokens."""
    k = len(xs)
    ps, avs = _specinfer_rounds(p, q, k)
    V = len(ps[0])
    from functools import lru_cache

    @lru_cache(maxsize=None)
    def B(i: int, S: tuple) -> tuple:
        # returns the (V,) output distribution after i rejections with
        # remaining multiset S (|S| == k - i).
        if i == k:
            return tuple(ps[k])
        a = avs[i]  # round i+1 accept vector (uses residual p_i)
        out = np.zeros(V, dtype=np.float64)
        m = len(S)
        for j in range(m):
            t = S[j]
            rest = tuple(sorted(S[:j] + S[j + 1 :]))
            out[t] += a[t] / m
            out += (1.0 - a[t]) / m * np.asarray(B(i + 1, rest))
        return tuple(out)

    return np.asarray(B(0, tuple(sorted(int(x) for x in xs))))


def specinfer_solve(p, q, xs, rng):
    p = np.asarray(p, dtype=np.float64).copy()
    q = np.asarray(q, dtype=np.float64)
    S = [int(x) for x in xs]
    while S:
        x = S[int(rng.integers(len(S)))]
        if rng.random() <= min(1.0, p[x] / max(q[x], _EPS)):
            return x
        p = _norm(_pos(p - q))
        S.remove(x)
    return int(rng.choice(len(p), p=_norm(p)))


def specinfer_acceptance(p, q, k):
    # Alg. 9 as written.
    p = np.asarray(p, dtype=np.float64).copy()
    q = np.asarray(q, dtype=np.float64)
    p_rej = 1.0
    m = np.ones_like(p)
    for _ in range(k):
        r = float(np.sum(np.minimum(p, q)))
        p_rej *= 1.0 - r
        m = m * (1.0 - _pos(q - p) / max(1.0 - r, _EPS))
        p = _norm(_pos(p - q))
    return (1.0 - p_rej) + p_rej * float(np.sum(p * (1.0 - m)))


# -------------------------------------------------------------- Khisti -------
#
# Canonical two-stage decomposition (Khisti et al., 2025): stage 1 selects a
# token with marginal r (an importance-weighted distribution realisable from k
# iid q-draws); stage 2 runs single-draft naive speculative sampling with
# proposal r.  We realise stage 1 with the K-SEQ OTLP solver *targeting r*:
# since K-SEQ is itself an OTLP solver, its output follows r exactly, so the
# composite is exactly lossless.  r is the water-filled optimum of
# max sum_x min(p, r)  s.t.  r(x) <= 1 - (1 - q(x))^k  (the availability bound).
# See DESIGN.md §7 for how this relates to the published construction.


def khisti_importance_sample(p, q, k):
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    u = 1.0 - (1.0 - q) ** k  # P(token available among the k draws)
    r = np.minimum(p, u)
    deficit = 1.0 - r.sum()
    head = u - r
    hs = head.sum()
    if deficit > 1e-15 and hs > 0:
        r = r + deficit * head / hs
    return _norm(r)


def khisti_output_dist(p, q, xs):
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    r = khisti_importance_sample(p, q, len(xs))
    d1 = spectr_output_dist(r, q, xs)  # stage-1 selection dist given xs
    a = np.minimum(1.0, p / np.maximum(r, _EPS))
    res = _norm(_pos(p - r))
    keep = d1 * a
    return keep + (1.0 - keep.sum()) * res


def khisti_solve(p, q, xs, rng):
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    r = khisti_importance_sample(p, q, len(xs))
    x = spectr_solve(r, q, xs, rng)
    if rng.random() <= min(1.0, p[x] / max(r[x], _EPS)):
        return x
    return int(rng.choice(len(p), p=_norm(_pos(p - r))))


def khisti_acceptance(p, q, k, n_mc: int = 96):
    """Acceptance of the two-stage construction.

    Alg. 10's closed-form lower bound (sum min(p, r)) assumes stage-1 always
    selects a *drafted* token (true for the published tournament).  Our
    stage-1 (K-SEQ targeting r; see module docstring) may output non-drafted
    tokens, so we compute the acceptance with exact inner output
    distributions and a seeded Monte Carlo outer expectation over drafts.
    """
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    V = len(q)
    if V**k <= 4096:  # exact outer enumeration when feasible
        import itertools

        acc = 0.0
        for xs in itertools.product(range(V), repeat=k):
            w = float(np.prod([q[x] for x in xs]))
            if w > 0:
                d = khisti_output_dist(p, q, list(xs))
                acc += w * sum(d[int(x)] for x in set(xs))
        return acc
    rng = np.random.default_rng(12345)
    acc = 0.0
    for _ in range(n_mc):
        xs = list(rng.choice(V, size=k, p=_norm(q)))
        d = khisti_output_dist(p, q, xs)
        acc += sum(d[int(x)] for x in set(xs))
    return acc / n_mc


def khisti_acceptance_lower(p, q, k):
    """Alg. 10 as printed: sum_t min(p, r) (valid for the tournament form)."""
    r = khisti_importance_sample(p, q, k)
    return float(np.sum(np.minimum(np.asarray(p, dtype=np.float64), r)))


# ------------------------------------------------------------ registry -------

OTLP_SOLVERS = {
    "nss": (nss_solve, nss_output_dist, nss_acceptance),
    "naive": (naive_solve, naive_output_dist, naive_acceptance),
    "spectr": (spectr_solve, spectr_output_dist, spectr_acceptance),
    "specinfer": (specinfer_solve, specinfer_output_dist, specinfer_acceptance),
    "khisti": (khisti_solve, khisti_output_dist, khisti_acceptance),
}

# NaiveTree is the Naive solver used in multi-path traversal (Table 1): the
# solver is identical; the tree walk treats all children as candidates.
OTLP_SOLVERS["naivetree"] = OTLP_SOLVERS["naive"]


def branching_probs(name: str, p, q, xs) -> np.ndarray:
    """Def. 5.3 / Appendix D: probability the solver outputs each draft token."""
    _, output_dist, _ = OTLP_SOLVERS[name]
    d = output_dist(p, q, xs)
    return np.asarray([d[int(x)] for x in xs])


def acceptance_rate(name: str, p, q, k: int) -> float:
    """Def. 5.1 / Appendix C."""
    _, _, acc = OTLP_SOLVERS[name]
    return acc(np.asarray(p, dtype=np.float64), np.asarray(q, dtype=np.float64), k)
