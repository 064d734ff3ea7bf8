"""On-device OTLP solvers and whole-tree top-down verification.

The counterpart of src/repro/core/otlp_jax.py, in torch.  The numpy
implementations in ``otlp.py``/``verify.py`` are the float64 oracles; these
keep a verification step on the device, with static shapes and no host
sync inside: the engine reads the three results once, at the end.  (JAX
jits them; here each is a fixed sequence of eager torch ops.)

Every function takes a leading batch axis: a solver solves B independent
problems, and ``verify_topdown_batched`` walks B trees in lockstep;
``verify_topdown`` is the one-tree form (B = 1).

    SOLVERS_DEVICE[name](p, q, xs, valid, generator)  -> (B,) int64 tokens
    verify_topdown(tokens, parent, p, q, generator, ...)
        -> (accepted (max_depth,) padded with -1, n_accepted, correction)

Randomness comes from an explicit ``torch.Generator`` on the tensors'
device.  The laws are those of the JAX solvers; the random streams are not
(torch cannot reproduce ``jax.random``), so tests hold these against the
numpy oracles by distribution (tests/test_torch_otlp_device.py).  Trees use
the flat layout of ``core.trees`` (parent == -1 beyond ``n_nodes``).
"""
from __future__ import annotations

import torch

from repro_torch.sampling import sample_categorical

_EPS = 1e-30
SPECTR_BISECTIONS = 60  # the JAX solver's fori_loop count


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Normalise the last axis; a row of zero mass becomes uniform."""
    s = v.sum(-1, keepdim=True)
    return torch.where(s > 0, v / s.clamp_min(_EPS), torch.full_like(v, 1.0 / v.shape[-1]))


def _pos(v: torch.Tensor) -> torch.Tensor:
    return v.clamp_min(0.0)


def _at(dist: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """dist[b, idx[b, ...]] for a (B, V) ``dist`` and (B,) or (B, k) ``idx``."""
    if idx.dim() == 1:
        return dist.gather(-1, idx[:, None])[:, 0]
    return dist.gather(-1, idx)


def _uniform(shape, like: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=like.device, dtype=like.dtype)


# ------------------------------------------------------------- solvers -------


def solve_nss(p, q, xs, valid, generator):
    return sample_categorical(_norm(p), generator)


def naive_residual(p, q):
    """The rejection residual (p - q)_+, normalised."""
    return _norm(_pos(p - q))


def solve_naive(p, q, xs, valid, generator):
    x1 = xs[:, 0]
    a = torch.clamp(_at(p, x1) / _at(q, x1).clamp_min(_EPS), max=1.0)
    accept = _uniform(a.shape, p, generator) < a
    alt = sample_categorical(naive_residual(p, q), generator)
    return torch.where(accept, x1, alt)


def _spectr_rho(p, q, k):
    """SpecTr's rho for each row: the root in [1, max(k, 1)] of
    1 - (1 - beta(rho))^k - rho beta(rho), beta(rho) = sum min(p / rho, q),
    by 60 bisections; 1 when g(1) <= 0, max(k, 1) when g(max(k, 1)) >= 0.
    ``k`` is a (B,) float tensor (the effective candidate count)."""
    k = k.to(p.dtype)
    kmax = k.clamp_min(1.0)

    def g(rho):
        b = torch.minimum(p / rho[:, None], q).sum(-1)
        return (1.0 - (1.0 - b) ** k) - rho * b

    lo, hi = torch.ones_like(kmax), kmax.clone()
    for _ in range(SPECTR_BISECTIONS):
        mid = 0.5 * (lo + hi)
        gt = g(mid) > 0
        lo, hi = torch.where(gt, mid, lo), torch.where(gt, hi, mid)
    rho = 0.5 * (lo + hi)
    rho = torch.where(g(torch.ones_like(kmax)) <= 0, 1.0, rho)
    return torch.where(g(kmax) >= 0, kmax, rho)


def spectr_residual(p, q, k):
    """(rho, the residual law of a SpecTr rejection) for k candidates."""
    k = k.to(p.dtype).clamp_min(1.0)
    rho = _spectr_rho(p, q, k)
    cap = torch.minimum(p / rho[:, None], q)
    beta = cap.sum(-1)
    p_acc = 1.0 - (1.0 - beta) ** k
    gamma = torch.where(beta > 0, p_acc / beta.clamp_min(_EPS), 0.0)
    return rho, _norm(_pos(p - cap * gamma[:, None]))


def solve_spectr(p, q, xs, valid, generator):
    rho, res = spectr_residual(p, q, valid.sum(-1))
    a = torch.clamp(_at(p, xs) / (rho[:, None] * _at(q, xs).clamp_min(_EPS)), max=1.0)
    a = torch.where(valid, a, 0.0)  # padded slots never accept
    accepts = _uniform(a.shape, p, generator) < a
    first = accepts.to(torch.int8).argmax(-1)  # the first accepting slot (0 if none)
    alt = sample_categorical(res, generator)
    return torch.where(accepts.any(-1), xs.gather(-1, first[:, None])[:, 0], alt)


def solve_specinfer(p, q, xs, valid, generator):
    """SpecInfer's sequential rejection over the candidates in a uniformly
    random order.  JAX's ``while_loop`` becomes k masked iterations: a row
    that accepted, or has no candidate left, keeps its state."""
    pcur, mask = _norm(p), valid.clone()
    done = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    out = torch.full((p.shape[0],), -1, dtype=xs.dtype, device=p.device)
    for _ in range(xs.shape[-1]):
        live = mask.any(-1) & ~done
        idx = sample_categorical(_norm(mask.to(p.dtype)), generator)
        x = xs.gather(-1, idx[:, None])[:, 0]
        a = torch.clamp(_at(pcur, x) / _at(q, x).clamp_min(_EPS), max=1.0)
        accept = (_uniform(a.shape, p, generator) < a) & live
        out = torch.where(accept, x, out)
        pcur = torch.where((live & ~accept)[:, None], naive_residual(pcur, q), pcur)
        done = done | accept
        mask = mask & ~(live[:, None] & (torch.arange(mask.shape[-1], device=p.device) == idx[:, None]))
    alt = sample_categorical(_norm(pcur), generator)
    return torch.where(done, out, alt)


def khisti_importance(p, q, k):
    """The two-stage coupling's importance law for k candidates (a (B,)
    float tensor): min(p, 1 - (1 - q)^k), its deficit spread over the
    headroom, normalised."""
    u = 1.0 - (1.0 - q) ** k.to(p.dtype)[:, None]
    r = torch.minimum(p, u)
    deficit = 1.0 - r.sum(-1)
    head = u - r
    hs = head.sum(-1)
    spread = (deficit > 1e-12) & (hs > 0)
    r = torch.where(spread[:, None], r + (deficit / hs.clamp_min(_EPS))[:, None] * head, r)
    return _norm(r)


def solve_khisti(p, q, xs, valid, generator):
    r = khisti_importance(p, q, valid.sum(-1).to(p.dtype).clamp_min(1.0))
    x = solve_spectr(r, q, xs, valid, generator)
    a = torch.clamp(_at(p, x) / _at(r, x).clamp_min(_EPS), max=1.0)
    accept = _uniform(a.shape, p, generator) < a
    alt = sample_categorical(naive_residual(p, r), generator)
    return torch.where(accept, x, alt)


SOLVERS_DEVICE = {
    "nss": solve_nss,
    "naive": solve_naive,
    "naivetree": solve_naive,
    "spectr": solve_spectr,
    "specinfer": solve_specinfer,
    "khisti": solve_khisti,
}


# ------------------------------------------------- on-device tree verify -----


def verify_topdown_batched(tokens, parent, p, q, generator, *, solver: str = "specinfer",
                           max_depth: int = 16, max_children: int = 4):
    """Top-down OT verification of B trees in lockstep.

    tokens, parent (B, N) int (node 0 the root, parent -1 for the root and
    padding), p, q (B, N, V) target and draft laws per node.  A fixed-depth
    walk of ``max_depth`` levels with early-exit masking: at each level the
    solver draws among the children of the active set (the first
    ``max_children`` in node order; duplicate drafted nodes share a context,
    so the active SET advances, as on the host), a leaf draws its
    correction from p, and a row stops at its first correction.

    Returns (accepted (B, max_depth) padded with -1, n_accepted (B,),
    correction (B,)), all on the device."""
    solve = SOLVERS_DEVICE[solver]
    B, N = tokens.shape
    dev = tokens.device
    tokens, parent = tokens.long(), parent.long()
    rows = torch.arange(B, device=dev)
    active = torch.zeros((B, N), dtype=torch.bool, device=dev)
    active[:, 0] = True
    out_tok = torch.full((B, max_depth), -1, dtype=torch.long, device=dev)
    n_acc = torch.zeros(B, dtype=torch.long, device=dev)
    corr = torch.full((B,), -1, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    has_parent = parent >= 0
    parent_safe = parent.clamp_min(0)
    for d in range(max_depth):
        is_child = active.gather(1, parent_safe) & has_parent
        node = active.to(torch.int8).argmax(1)  # a representative: the set shares a context
        order = torch.argsort((~is_child).to(torch.int8), dim=1, stable=True)  # children first
        child_nodes = order[:, :max_children]
        child_valid = is_child.gather(1, child_nodes)
        xs = torch.where(child_valid, tokens.gather(1, child_nodes), 0)
        pn, qn = p[rows, node], q[rows, node]
        y = solve(pn, qn, xs, child_valid, generator)
        is_leaf = ~is_child.any(1)
        y = torch.where(is_leaf, sample_categorical(_norm(pn), generator), y)
        matches = is_child & (tokens == y[:, None])
        advance = matches.any(1) & ~is_leaf
        keep = ~done
        step = keep & advance
        out_tok[:, d] = torch.where(step, y, out_tok[:, d])
        n_acc = n_acc + step.long()
        corr = torch.where(keep, torch.where(advance, -1, y), corr)
        active = torch.where(keep[:, None], matches, active)
        done = done | ~advance
    return out_tok, n_acc, corr


def verify_topdown(tokens, parent, p, q, generator, *, solver: str = "specinfer",
                   max_depth: int = 16, max_children: int = 4):
    """One tree (tokens, parent (N,), p, q (N, V)): ``verify_topdown_batched``
    at B = 1.  Returns (accepted (max_depth,) padded with -1, n_accepted,
    correction) as device tensors."""
    out_tok, n_acc, corr = verify_topdown_batched(tokens[None], parent[None], p[None], q[None], generator,
                                                  solver=solver, max_depth=max_depth,
                                                  max_children=max_children)
    return out_tok[0], n_acc[0], corr[0]
