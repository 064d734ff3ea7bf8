"""Tree verification.

Top-down OT-based traversal (Sec. 3.2): starting at the root, repeatedly run
the OTLP solver on (p, q, child tokens); move to the child matching the output
token, or terminate emitting it as the correction token.

Merged-context semantics: drafted paths are stored unmerged (see trees.py), so
the traversal tracks the *active set* of nodes sharing the current context.
The child list is the multiset of child tokens over the active set — exactly
the multiplicity semantics of Def. 3.1.

Also: single-path Naive and Block Verification (BV, Sun et al. 2024c) with the
nested single-uniform coupling:

    w_0 = 1,  w_i = min(1, w_{i-1} * p_i(x_i) / q_i(x_i))
    P(tau >= i) = w_i           (single U; tau = max{i : w_i >= U})
    correction at tau = i < L:  r_i ∝ (w_i * p_{i+1}(.) - q_{i+1}(.) * w_{i+1}(.))_+
                              = (w_i * p_{i+1} - q_{i+1})_+   [since w_{i+1}(s)
                                = min(1, w_i p(s)/q(s))]
    correction at tau = L:      p_{L+1}

which reduces to naive speculative sampling's accept/residual at L=1.

The module also owns the *verifier registry* — the single place a
verification algorithm is given a name.  Every engine mode (single-stream,
batched, sharded, pipelined) resolves ``EngineConfig.verifier`` through
``get_verifier``, and the losslessness property tests, the Table-1 matrix
harness and ``launch/serve.py --verifier`` all enumerate ``VERIFIERS`` — a
new verifier registered here is tested, benchmarked and servable by
construction (docs/verifiers.md).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.otlp import OTLP_SOLVERS, _norm, _pos
from repro_torch.core.trees import DraftTree


# ------------------------------------------------------- top-down OT walk ----


def verify_topdown(tree: DraftTree, solver: str, rng: np.random.Generator):
    """Run an OT-based verifier on a drafted tree with target dists attached.

    Returns (accepted_tokens, correction_token): the emitted block is
    accepted_tokens + [correction_token].
    """
    assert tree.p is not None, "attach_target first"
    solve, _, _ = OTLP_SOLVERS[solver]
    active = [0]
    accepted: list[int] = []
    while True:
        kids = tree.children_of_set(active)
        node = active[0]
        p, q = tree.p[node], tree.q[node]
        if not kids:
            return accepted, int(rng.choice(len(p), p=_norm(np.asarray(p))))
        xs = [int(tree.tokens[c]) for c in kids]
        y = solve(p, q, xs, rng)
        matches = [c for c in kids if int(tree.tokens[c]) == y]
        if not matches:
            return accepted, int(y)
        accepted.append(int(y))
        active = matches


def verify_topdown_output_dist(tree: DraftTree, solver: str) -> dict:
    """Exact distribution over emitted blocks, conditioned on the tree.

    Returns {tuple(block_tokens): probability}.  Used by the enumeration
    losslessness tests (expectation over trees must equal the target process).
    """
    assert tree.p is not None
    _, output_dist, _ = OTLP_SOLVERS[solver]
    out: dict = {}

    def rec(active: list[int], prefix: tuple, mass: float):
        if mass <= 0:
            return
        kids = tree.children_of_set(active)
        node = active[0]
        p, q = tree.p[node], tree.q[node]
        if not kids:
            for t, pt in enumerate(p):
                if pt > 0:
                    key = prefix + (t,)
                    out[key] = out.get(key, 0.0) + mass * float(pt)
            return
        xs = [int(tree.tokens[c]) for c in kids]
        d = output_dist(p, q, xs)
        xs_set = set(xs)
        for t, dt in enumerate(d):
            if dt <= 0:
                continue
            if t in xs_set:
                rec([c for c in kids if int(tree.tokens[c]) == t], prefix + (t,), mass * float(dt))
            else:
                key = prefix + (t,)
                out[key] = out.get(key, 0.0) + mass * float(dt)

    rec([0], (), 1.0)
    return out


# ------------------------------------------------ single-path Naive / BV -----


def _single_path(tree: DraftTree) -> list[int]:
    path = []
    node = 0
    while True:
        kids = tree.children(node)
        if not kids:
            return path
        assert len(kids) == 1, "single-path verifier on a branching tree"
        node = kids[0]
        path.append(node)


def verify_naive_single(tree: DraftTree, rng: np.random.Generator):
    """Original speculative sampling on a single-path tree (Sec. 3.1)."""
    assert tree.p is not None
    path = _single_path(tree)
    accepted: list[int] = []
    node = 0
    for v in path:
        t = int(tree.tokens[v])
        p, q = tree.p[node], tree.q[node]
        if rng.random() <= min(1.0, p[t] / max(q[t], 1e-300)):
            accepted.append(t)
            node = v
        else:
            corr = int(rng.choice(len(p), p=_norm(_pos(np.asarray(p) - np.asarray(q)))))
            return accepted, corr
    return accepted, int(rng.choice(tree.vocab, p=_norm(np.asarray(tree.p[node]))))


def verify_bv(tree: DraftTree, rng: np.random.Generator):
    """Block Verification on a single-path tree.

    BV is exactly Traversal Verification restricted to a path (the K=1
    reduction holds by construction): the whole chain is the trunk, the
    branch stage is empty, and the trunk stage performs the conditional
    leaf-to-root climb with nested weights.  See traversal.py for the math.
    """
    from repro_torch.core.traversal import verify_traversal

    _single_path(tree)  # asserts path structure
    return verify_traversal(tree, rng)


def verify_bv_output_dist(tree: DraftTree) -> dict:
    """Exact emitted-block distribution of BV conditioned on the tree."""
    from repro_torch.core.traversal import verify_traversal_output_dist

    _single_path(tree)
    return verify_traversal_output_dist(tree)


# ----------------------------------------------------------------- registry --


@runtime_checkable
class Verifier(Protocol):
    """The pluggable verifier contract.

    ``verify``      samples one verification round on a target-attached tree
                    and returns (accepted_tokens, correction_token).
    ``output_dist`` is the *exact* conditional law of the emitted block given
                    the tree, {block_tuple: probability} — the object the
                    enumeration losslessness tests integrate over trees.
    """

    name: str

    def verify(self, tree: DraftTree, rng: np.random.Generator) -> tuple[list[int], int]: ...

    def output_dist(self, tree: DraftTree) -> dict: ...


@dataclass(frozen=True)
class VerifierSpec:
    """Registry entry.  ``verify``/``output_dist`` are plain callables with
    the Verifier protocol signatures.

    multipath : handles branching trees (K >= 2); single-path verifiers
                (naive_single, bv) require K == 1 drafts.
    on_device : has a batched on-device OT solve (core/otlp_jax.py) behind
                ``EngineConfig.verify_on_device`` — the top-down OT family.
    cite      : short provenance string surfaced by docs and the matrix
                harness.
    """

    name: str
    _verify: Callable = field(repr=False)
    _output_dist: Callable = field(repr=False)
    multipath: bool = True
    on_device: bool = False
    cite: str = ""

    def verify(self, tree: DraftTree, rng: np.random.Generator):
        return self._verify(tree, rng)

    def output_dist(self, tree: DraftTree) -> dict:
        return self._output_dist(tree)


VERIFIERS: dict[str, VerifierSpec] = {}


def register_verifier(spec: VerifierSpec) -> VerifierSpec:
    """Register a verifier by name.  Fails loudly on duplicates — shadowing a
    verification algorithm silently is never what anyone wants."""
    if spec.name in VERIFIERS:
        raise ValueError(f"verifier {spec.name!r} already registered")
    VERIFIERS[spec.name] = spec
    return spec


def get_verifier(name: str) -> VerifierSpec:
    """Resolve a verifier by name; unknown names list the registry."""
    try:
        return VERIFIERS[name]
    except KeyError:
        raise ValueError(
            f"unknown verifier {name!r}; registered: {', '.join(sorted(VERIFIERS))}"
        ) from None


def verifier_names() -> list[str]:
    return sorted(VERIFIERS)


def _register_builtins():
    from repro_torch.core.greedy_bv import greedy_mpbv_output_dist, verify_greedy_mpbv
    from repro_torch.core.traversal import verify_traversal, verify_traversal_output_dist
    from repro_torch.core.univer import univer_output_dist, verify_univer

    _OT_CITES = {
        "nss": "NSS OT coupling (paper Sec. 3.2)",
        "naive": "k-draw naive coupling (paper Sec. 3.2)",
        "naivetree": "alias of naive (tree form)",
        "spectr": "SpecTr (Sun et al., 2023)",
        "specinfer": "SpecInfer (Miao et al., 2023)",
        "khisti": "two-stage importance coupling (Khisti et al., 2024)",
    }
    for solver in _OT_CITES:

        def _v(tree, rng, _s=solver):
            return verify_topdown(tree, _s, rng)

        def _d(tree, _s=solver):
            return verify_topdown_output_dist(tree, _s)

        register_verifier(VerifierSpec(solver, _v, _d, multipath=True, on_device=True,
                                       cite=_OT_CITES[solver]))
    register_verifier(VerifierSpec(
        "traversal", verify_traversal, verify_traversal_output_dist,
        multipath=True, cite="Traversal Verification (Weng et al., 2025)"))
    register_verifier(VerifierSpec(
        "naive_single", verify_naive_single, _naive_single_output_dist,
        multipath=False, cite="speculative sampling (Leviathan et al., 2023)"))
    register_verifier(VerifierSpec(
        "bv", verify_bv, verify_bv_output_dist,
        multipath=False, cite="Block Verification (Sun et al., 2024)"))
    register_verifier(VerifierSpec(
        "univer", verify_univer, univer_output_dist,
        multipath=True, cite="UniVer unified multi-step x multi-draft (arXiv 2605.04543)"))
    register_verifier(VerifierSpec(
        "greedy_mpbv", verify_greedy_mpbv, greedy_mpbv_output_dist,
        multipath=True, cite="Greedy Multi-Path Block Verification (arXiv 2602.16961)"))


def _naive_single_output_dist(tree: DraftTree) -> dict:
    """Exact emitted-block law of naive single-path speculative sampling."""
    path = _single_path(tree)
    out: dict = {}
    node, mass = 0, 1.0
    prefix: tuple = ()
    for v in path:
        t = int(tree.tokens[v])
        p, q = np.asarray(tree.p[node], np.float64), np.asarray(tree.q[node], np.float64)
        a = min(1.0, float(p[t]) / max(float(q[t]), 1e-300))
        resid = _pos(p - q)
        if a < 1.0 and resid.sum() > 0:
            resid = _norm(resid)
            for s, ps in enumerate(resid):
                if ps > 0:
                    key = prefix + (s,)
                    out[key] = out.get(key, 0.0) + mass * (1.0 - a) * float(ps)
        mass *= a
        prefix = prefix + (t,)
        node = v
    p = np.asarray(tree.p[node], np.float64)
    for s, ps in enumerate(p):
        if ps > 0:
            key = prefix + (s,)
            out[key] = out.get(key, 0.0) + mass * float(ps)
    return out


_register_builtins()
