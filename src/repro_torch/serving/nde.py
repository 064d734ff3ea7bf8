"""NDE (neural dynamic expansion) selector wiring for the engines.

The counterpart of src/repro/serving/nde.py.  Builds App. E features from
the stream state, evaluates the selector MLP on the device its parameters
lie on, and returns the (K, L1, L2) action.  Also provides the *analytic*
selector (beyond-paper): exhaustive Eq. 9 maximisation using the exact
Eq. 3 branching estimator against the engine's own models.

Two quirks of the reference are kept so that the port chooses the same
actions (ROADMAP queue 3): ``NeuralSelector`` feeds the raw scalar features
to a selector that ``train_selector`` fitted on standardised ones, and it
feeds ``h_prev_q`` as ``h_cur_q``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.delayed import LatencyModel, estimate_block_efficiency
from repro_torch.core.selector import make_scalar_features, select_action


class NeuralSelector:
    """selector(stream, engine) -> (K, L1, L2) using a trained MLP policy."""

    def __init__(self, params, cfg, latency: LatencyModel, sampling):
        self.params = params
        self.cfg = cfg
        self.latency = latency
        self.sampling = sampling
        self.device = params["out"]["w"].device

    def features(self, stream, engine):
        V = engine.tc.vocab
        p_prev = stream.get("p_prev")
        q_prev = stream.get("q_prev")
        if p_prev is None:
            p_prev = np.full(V, 1.0 / V)
        if q_prev is None:
            q_prev = np.full(V, 1.0 / V)
        # q at root: the draft dist produced while ingesting the delta is not
        # yet known at selection time for the *next* root — use q_prev as the
        # freshest proxy (matches "previous token" features of App. E).
        l = len(stream["committed"])
        scal = make_scalar_features(
            p_prev,
            q_prev,
            q_prev,
            l,
            self.sampling.temperature,
            self.sampling.top_p,
            self.latency.t_q(l),
            self.latency.t_p(l),
        )

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32)[None], device=self.device)

        return dev(stream["h_prev_p"]), dev(stream["h_prev_q"]), dev(stream["h_prev_q"]), dev(scal)

    def __call__(self, stream, engine):
        hp, hq, hc, sc = self.features(stream, engine)
        return select_action(self.params, hp, hq, hc, sc, self.cfg.space)


class StaticSelector:
    def __init__(self, K, L1, L2):
        self.a = (K, L1, L2)

    def __call__(self, stream, engine):
        return self.a


class AnalyticSelector:
    """Beyond-paper oracle: enumerate a small action grid, estimate Eq. 3
    block efficiency with s tree samples against the engine's real draft and
    target, and pick argmax of Ê[tau+1]/T̂ (Eq. 9).  Expensive (extra model
    calls) — used offline to label NDE training data and as an upper bound."""

    def __init__(self, actions, latency: LatencyModel, solver: str, s: int = 1, seed: int = 0):
        self.actions = actions
        self.latency = latency
        self.solver = solver
        self.s = s
        self.rng = np.random.default_rng(seed)

    def __call__(self, stream, engine):
        # model oracles over *contexts relative to the committed prefix*.
        # Both engines provide them (the batched engine peeks a gathered
        # pool row); anything else must fail LOUDLY — degrading to a default
        # action here would silently un-do the selector the caller asked for.
        peek_q = getattr(engine, "peek_draft_dist", None)
        peek_p = getattr(engine, "peek_target_dist", None)
        if peek_q is None or peek_p is None:
            raise TypeError(
                f"AnalyticSelector needs peek_draft_dist/peek_target_dist "
                f"oracles, which {type(engine).__name__} does not provide; "
                f"use SpeculativeEngine or BatchedSpeculativeEngine, or switch "
                f"to NeuralSelector/StaticSelector"
            )
        base = list(stream["committed"])

        def q_fn(ctx):
            return peek_q(stream, list(ctx))

        def p_fn(ctx):
            return peek_p(stream, list(ctx))

        best, best_tps = self.actions[0], -1.0
        l = len(base)
        for K, L1, L2 in self.actions:
            eff = estimate_block_efficiency(
                self.rng, q_fn, p_fn, self.solver, K, L1, L2, context=(), s=self.s
            )
            tps = eff / self.latency.action_time(l, K, L1, L2)
            if tps > best_tps:
                best, best_tps = (K, L1, L2), tps
        return best
