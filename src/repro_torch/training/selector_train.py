"""Offline NDE selector training (Sec. 6.1 / App. E), in torch.

The counterpart of src/repro/training/selector_train.py.  Pipeline:
  1. collect_traces: run the engine along target trajectories, taking a root
     every ``stride`` tokens; at each root, estimate E^[tau+1] for every
     action on the grid with the Eq. 3 estimator (s i.i.d. delayed trees)
     against the *real* draft/target, and T^ with the Eq. 11 latency model.
  2. train_selector: minimise the Eq. 12 objective with AdamW.

The static baseline action per sampling configuration follows the paper: the
best fixed (K, L1, L2) on the trace set for that (temperature, top_p).

Minibatch indices come from the same numpy rng as in the JAX package, so a
run with ``dropout=0`` from the same initial parameters takes the same
steps; initial weights and dropout masks come from a ``torch.Generator``
seeded with ``seed`` on the training device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.delayed import LatencyModel, estimate_block_efficiency
from repro_torch.core.selector import (
    SelectorConfig,
    init_selector,
    make_scalar_features,
    selector_loss,
)
from repro_torch.training.optim import AdamW, tree_map


def collect_traces(
    engine,
    prompts: list[list[int]],
    actions: list[tuple],
    latency: LatencyModel,
    *,
    tokens_per_prompt: int = 32,
    stride: int = 8,
    s: int = 2,
    seed: int = 0,
) -> dict:
    """Returns arrays: h_prev_p, h_prev_q, h_cur_q, scalars, eff, time."""
    rng = np.random.default_rng(seed)
    rows = {k: [] for k in ["h_prev_p", "h_prev_q", "h_cur_q", "scalars", "eff", "time"]}
    for prompt in prompts:
        stream = engine.new_stream(list(prompt))
        produced = 0
        since_root = stride  # take the first root immediately
        while produced < tokens_per_prompt:
            if since_root >= stride:
                since_root = 0
                # ---- label one root ----
                def q_fn(ctx):
                    return engine.peek_draft_dist(stream, list(ctx))

                def p_fn(ctx):
                    return engine.peek_target_dist(stream, list(ctx))

                l = len(stream["committed"])
                effs, times = [], []
                for (K, L1, L2) in actions:
                    effs.append(
                        estimate_block_efficiency(rng, q_fn, p_fn, engine.ecfg.verifier, K, L1, L2, s=s)
                    )
                    times.append(latency.action_time(l, K, L1, L2))
                V = engine.tc.vocab
                p_prev = stream["p_prev"] if stream["p_prev"] is not None else np.full(V, 1 / V)
                q_prev = stream["q_prev"] if stream["q_prev"] is not None else np.full(V, 1 / V)
                q_root = engine.peek_draft_dist(stream, [])
                rows["h_prev_p"].append(np.asarray(stream["h_prev_p"], np.float32))
                rows["h_prev_q"].append(np.asarray(stream["h_prev_q"], np.float32))
                rows["h_cur_q"].append(np.asarray(stream["h_prev_q"], np.float32))
                rows["scalars"].append(
                    make_scalar_features(
                        p_prev, q_prev, q_root, l,
                        engine.sampling.temperature, engine.sampling.top_p,
                        latency.t_q(l), latency.t_p(l),
                    )
                )
                rows["eff"].append(np.asarray(effs, np.float32))
                rows["time"].append(np.asarray(times, np.float32))
            new = engine.step(stream)
            produced += len(new)
            since_root += len(new)
    return {k: np.stack(v) for k, v in rows.items()}


def best_static_action(traces: dict) -> int:
    """Index of the fixed action with the best average offline throughput."""
    tps = traces["eff"] / traces["time"]
    return int(np.argmax(tps.mean(axis=0)))


def train_selector(
    traces: dict,
    scfg: SelectorConfig,
    *,
    steps: int = 300,
    batch: int = 32,
    lr: float = 1e-3,
    lam: float = 1.0,
    cvar_alpha: float = 0.25,
    aux_ce: float = 0.5,
    seed: int = 0,
    base_idx: int | None = None,
    device="cuda",
):
    """Returns (params on ``device``, per-step losses)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_selector(scfg, gen, device)
    opt = AdamW(lr=lr, total_steps=steps, warmup_steps=max(steps // 20, 1))
    state = opt.init(params)
    n = traces["eff"].shape[0]
    if base_idx is None:
        base_idx = best_static_action(traces)
    base = np.full(n, base_idx, np.int64)
    host = {
        "h_prev_p": traces["h_prev_p"],
        "h_prev_q": traces["h_prev_q"],
        "h_cur_q": traces["h_cur_q"],
        "scalars": _standardize(traces["scalars"]),
        "eff": traces["eff"],
        "time": traces["time"],
        "base": base,
    }
    data = {k: torch.as_tensor(np.ascontiguousarray(v), device=device) for k, v in host.items()}

    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(steps):
        idx = torch.as_tensor(rng.integers(0, n, size=min(batch, n)), device=device)
        batch_d = {k: v[idx] for k, v in data.items()}
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = selector_loss(leaves, batch_d, lam=lam, cvar_alpha=cvar_alpha, aux_ce=aux_ce,
                             generator=gen, dropout=scfg.dropout)
        loss.backward()
        grads = tree_map(lambda p: p.grad, leaves)
        params, state = opt.update(grads, state, tree_map(lambda p: p.detach(), leaves))
        losses.append(float(loss.detach()))
    return params, losses


def _standardize(x: np.ndarray) -> np.ndarray:
    mu = x.mean(axis=0, keepdims=True)
    sd = x.std(axis=0, keepdims=True) + 1e-6
    return (x - mu) / sd
