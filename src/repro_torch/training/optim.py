"""AdamW over nested dicts of tensors: the update of src/repro/training/optim.py.

Written out rather than ``torch.optim.AdamW``, which differs from the JAX
package's update in three places: the schedule is evaluated at the
incremented step (so the first update already uses ``2 / warmup_steps`` of
the rate), gradients are clipped by ``min(1, clip / max(gnorm, 1e-9))``
(``clip_grad_norm_`` divides by ``gnorm + 1e-6``), and the bias corrections
divide the moments before the square root (torch folds them into the step
size and the denominator).  Scalars are float32 tensors on the parameters'
device, as in the JAX package, so no step waits on the host.  The state
mirrors the params; the step count is a host int.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch


def tree_leaves(tree) -> list[torch.Tensor]:
    """Leaves in sorted-key order (the order ``jax.tree.leaves`` uses for dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


@dataclass(frozen=True)
class AdamW:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float | None = 1.0
    warmup_steps: int = 0
    total_steps: int | None = None  # enables cosine decay when set

    def init(self, params) -> AdamWState:
        zeros = lambda p: tree_map(torch.zeros_like, p)
        return AdamWState(step=0, mu=zeros(params), nu=zeros(params))

    def schedule(self, step: int, device) -> torch.Tensor:
        """The learning rate at ``step`` as a float32 scalar tensor."""
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
        lr = f32(self.lr)
        if self.warmup_steps > 0:
            lr = lr * torch.clamp_max(f32(step + 1) / f32(self.warmup_steps), 1.0)
        if self.total_steps is not None:
            frac = torch.clamp((f32(step) - f32(self.warmup_steps))
                               / f32(max(self.total_steps - self.warmup_steps, 1)), 0.0, 1.0)
            lr = lr * 0.5 * (1.0 + torch.cos(f32(math.pi) * frac))
        return lr

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """One step; returns (new params, new state).  Gradients and params
        are not modified."""
        step = state.step + 1
        device = tree_leaves(params)[0].device
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
        if self.clip_norm is not None:
            sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
            gnorm = torch.sqrt(sum(sq[1:], sq[0]))
            scale = torch.clamp_max(f32(self.clip_norm) / torch.clamp_min(gnorm, 1e-9), 1.0)
            grads = tree_map(lambda g: g * scale, grads)
        mu = tree_map(lambda m, g: self.b1 * m + (1 - self.b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: self.b2 * v + (1 - self.b2) * torch.square(g), state.nu, grads)
        bc1 = 1 - torch.pow(f32(self.b1), f32(step))
        bc2 = 1 - torch.pow(f32(self.b2), f32(step))
        lr = self.schedule(step, device)

        def upd(p, m, v):
            mhat = m / bc1
            vhat = v / bc2
            return (p - lr * (mhat / (torch.sqrt(vhat) + self.eps) + self.weight_decay * p)).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, AdamWState(step=step, mu=mu, nu=nu)
