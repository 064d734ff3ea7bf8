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

Dtypes follow JAX's promotion, which torch's differs from: in JAX the
float32 clip scale is a strongly typed array, so ``g * scale`` lifts bf16
gradients to float32 and the moments are float32 from the first update on
(with bf16 moments, ``b2 * v`` at b2 = 0.999 rounds back to ``v``: the
second moment would never decay).  A 0-dim torch tensor does not promote,
so each leaf is widened explicitly.  ``init`` allocates the moments in
that dtype at once (zeros either way, so the values are JAX's).

On DTensor leaves (training over a ``DeviceMesh``, launch/train.py) the
update runs shard by shard: each gradient first takes its parameter's
placements, the global norm sums every rank's local squares (a leaf
replicated on a mesh dim counted once) into one ``Partial`` scalar that is
reduced once, and the elementwise update runs on each rank's local shards
(the same arithmetic as on the whole leaf, without DTensor's dispatch).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial


def tree_leaves(tree) -> list[torch.Tensor]:
    """Leaves in sorted-key order (the order ``jax.tree.leaves`` uses for dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def global_sq_norm(grads: list) -> torch.Tensor:
    """The sum of squares of every element of ``grads`` as a float32
    scalar.  Of DTensors (each placed as its parameter): each rank's local
    sums, a leaf divided by the ranks that hold the same shard (a power of
    two on the meshes here, so exactly), added into one ``Partial`` scalar
    and reduced once."""
    if not isinstance(grads[0], DTensor):
        sq = [torch.sum(torch.square(g.float())) for g in grads]
        return sum(sq[1:], sq[0])
    mesh = grads[0].device_mesh
    local = [torch.sum(torch.square(g.to_local().float()))
             / math.prod(mesh.size(i) for i, pl in enumerate(g.placements) if pl.is_replicate()) for g in grads]
    part = sum(local[1:], local[0])
    return DTensor.from_local(part, mesh, (Partial(),) * mesh.ndim, run_check=False).full_tensor()


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

    def moment_dtype(self, p: torch.Tensor) -> torch.dtype:
        """The dtype JAX's moments of ``p`` take: that of ``g * scale``."""
        return torch.promote_types(p.dtype, torch.float32) if self.clip_norm is not None else p.dtype

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, dtype=self.moment_dtype(p))
        return AdamWState(step=0, mu=tree_map(zeros, params), nu=tree_map(zeros, params))

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
        """One step; returns (new params, new state).  Gradients, params and
        state are not modified: ``update_`` on copies."""
        clone = lambda t: tree_map(torch.clone, t)
        return self.update_(grads, AdamWState(state.step, clone(state.mu), clone(state.nu)), clone(params))

    @torch.no_grad()
    def update_(self, grads, state: AdamWState, params):
        """The same step written into ``params`` and the moments in place,
        leaf by leaf (torch.optim's idiom; the values are JAX's functional
        update's).  So the card holds one copy of the moments and no
        whole-tree temporaries.  Returns (params, new state)."""
        step = state.step + 1
        leaves = tree_leaves(params)
        device = leaves[0].device
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
        gs = tree_leaves(grads)
        sharded = isinstance(leaves[0], DTensor)
        if sharded:  # a gradient may come back Partial or otherwise placed than its parameter
            gs = [g if g.placements == p.placements else g.redistribute(p.device_mesh, p.placements)
                  for p, g in zip(leaves, gs)]
        scale = None
        if self.clip_norm is not None:
            gnorm = torch.sqrt(global_sq_norm(gs))
            scale = torch.clamp_max(f32(self.clip_norm) / torch.clamp_min(gnorm, 1e-9), 1.0)
        bc1 = 1 - torch.pow(f32(self.b1), f32(step))
        bc2 = 1 - torch.pow(f32(self.b2), f32(step))
        lr = self.schedule(step, device)
        local = (lambda t: t.to_local()) if sharded else (lambda t: t)  # a view of the shard: written in place
        for p, g, m, v in zip(leaves, gs, tree_leaves(state.mu), tree_leaves(state.nu)):
            self._update_leaf(local(p), local(g), local(m), local(v), scale, bc1, bc2, lr)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)

    def _update_leaf(self, p, g, m, v, scale, bc1, bc2, lr):
        if m.dtype != self.moment_dtype(p) or v.dtype != m.dtype:
            raise ValueError(f"moments of {m.dtype}/{v.dtype} for a {p.dtype} parameter: take them from init")
        if scale is not None:
            g = g.to(torch.promote_types(g.dtype, scale.dtype)) * scale
        # JAX casts a Python scalar to the array's dtype (weak typing): bf16
        # moments decay by bf16(b1) = 0.8984375, not by 0.9
        b1, b2, c1, c2 = (float(torch.tensor(x, dtype=m.dtype)) for x in
                          (self.b1, self.b2, 1 - self.b1, 1 - self.b2))
        m.mul_(b1).add_(c1 * g)
        v.mul_(b2).add_(c2 * torch.square(g))
        del g
        # p - lr * (m / bc1 / (sqrt(v / bc2) + eps) + wd * p), in the dtype JAX's float32 scalars give
        wide = torch.promote_types(torch.promote_types(p.dtype, m.dtype), torch.float32)
        den = (v.to(wide) / bc2).sqrt_().add_(self.eps)
        u = (m.to(wide) / bc1).div_(den)
        del den
        u.add_(self.weight_decay * p).mul_(lr)
        p.copy_(u.neg_().add_(p))
