"""Mixture-of-Experts layer: sort-free dropless dispatch for inference, the
capacity-factor dispatch for training.

The counterpart of src/repro/models/moe.py (``init_moe``, ``moe_capacity``,
``moe_apply``).  Tokens are scattered into per-expert buffers (E, C, D) at
computed slot indices (the rank of each (token, choice) within its expert),
the expert SwiGLU runs as one batched product per expert weight over
(E, C, D), and the outputs are gathered back weighted by the renormalised
gates.

Inference routing is DROPLESS: C is the call's token count, so every
(token, choice) has its own slot and a token's output never depends on the
tokens that share its call.  The batched engine's exactness (padded and
ragged passes, idle and padding lanes) rests on this.  The JAX package
rounds C up to a multiple of 8 for TPU tiling; the extra slots are zero rows
whose outputs are never gathered, so C = N here gives the same result.

Training (``train=True``, set by ``loss_fn``) keeps JAX's capacity-factor
dispatch: C = ceil(N * top_k * capacity_factor / E), rounded up to a
multiple of 8 and at least 8.  Here the rounding is semantics, not tiling:
it decides which (token, choice) pairs overflow their expert and are
dropped.  A dropped pair goes to a drop-bin row E * C, which many pairs
share (so the dispatch adds, as JAX's ``.at[].add``), and reads a zero row
back at the combine.

Nothing here reads a tensor back to the host (no ``.item()``, no boolean
indexing, no loop over per-expert counts, no ``bincount``): an MoE layer
enqueues its work like any other, so the pipelined engine's dispatch never
stalls on it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.act_sharding import replicated
from repro_torch.models.layers import init_dense


def init_moe(cfg, gen: torch.Generator) -> dict:
    """The router in float32 whatever the model dtype (routing must not see
    rounded logits), the expert weights (E, d, f) / (E, f, d) in the model's
    dtype, normal x 1/sqrt(d_in) as in the JAX package."""
    dt, dev = cfg.tdtype, gen.device
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def experts(din, dout):
        w = torch.randn((E, din, dout), generator=gen, device=dev, dtype=torch.float32)
        return (w / np.sqrt(din)).to(dt)

    return {
        "router": init_dense(gen, d, E, torch.float32),
        "w_gate": experts(d, f),
        "w_up": experts(d, f),
        "w_down": experts(f, d),
    }


def drops(cfg, train: bool) -> bool:
    """Whether the dispatch bounds each expert's buffer and drops overflow."""
    return train and cfg.capacity_factor > 0


def moe_capacity(n_tokens: int, cfg, train: bool = False) -> int:
    """Per-expert buffer size.  Dropless inference: the top_k experts of one
    token are distinct, so no expert takes more than n_tokens.  Training:
    the capacity-factor bound of the JAX package, in multiples of 8 (at
    least 8); the pairs past it are dropped."""
    if not drops(cfg, train):
        return n_tokens
    c = int(np.ceil(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, int(np.ceil(c / 8) * 8))


def route(p: dict, cfg, xf: torch.Tensor):
    """xf (N, D) -> (probs (N, E) fp32, renormalised gates top_p (N, k),
    experts top_e (N, k), slot (N*k,)): slot is the rank of each (token,
    choice) within its expert in flat order: a stable sort groups the expert
    ids and a cumulative count gives the group starts."""
    E, k = cfg.n_experts, cfg.top_k
    logits = xf.float() @ p["router"]  # (N, E), fp32
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)  # (N, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    flat_e = top_e.reshape(-1)  # (N*k,)
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    hist = torch.zeros(E, dtype=torch.int64, device=xf.device).index_add_(
        0, flat_e, torch.ones(n, dtype=torch.int64, device=xf.device))
    starts = torch.cumsum(hist, 0) - hist
    rank_sorted = torch.arange(n, device=xf.device) - starts[flat_e[order]]
    slot = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    return probs, top_p, top_e, slot


def moe_apply(p: dict, cfg, x: torch.Tensor, train: bool = False):
    """x (B, S, D) -> (y (B, S, D), aux (scalar fp32 load-balance loss))."""
    # the routing's index_add_/scatter_ and the dispatch's index_add/index_copy_
    # have no DTensor sharding rule: a sharded layer runs whole on every rank
    # (the capacity is the global batch's, as under JAX's partitioner)
    if isinstance(x, DTensor):
        return replicated(_moe_apply, p, cfg, x, train)
    return _moe_apply(p, cfg, x, train)


def _moe_apply(p: dict, cfg, x: torch.Tensor, train: bool):
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * S
    C = moe_capacity(N, cfg, train)
    xf = x.reshape(N, D)
    probs, top_p, top_e, slot = route(p, cfg, xf)

    # load-balance auxiliary loss (Switch-style), as the JAX package returns it
    me = probs.mean(dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, top_e[:, 0], torch.ones(N, dtype=torch.float32, device=x.device)) / N
    aux = E * torch.sum(me * ce)

    flat_e = top_e.reshape(-1)
    src = xf.repeat_interleave(k, dim=0)  # (N*k, D)
    if drops(cfg, train):
        # a pair past its expert's capacity goes to the drop bin E*C, which
        # many pairs share: add, as JAX's scatter-add does
        flat_idx = torch.where(slot < C, flat_e * C + slot, E * C)
        buf = x.new_zeros((E * C + 1, D)).index_add(0, flat_idx, src)[: E * C].view(E, C, D)
    else:
        # every index is distinct (rank < the expert's load <= N = C), so a
        # copy equals JAX's scatter-add into zeros
        flat_idx = flat_e * C + slot
        buf = x.new_zeros((E * C, D)).index_copy_(0, flat_idx, src).view(E, C, D)

    # expert FFN: batched SwiGLU, one product per expert weight
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"]).view(E * C, D)
    if drops(cfg, train):  # the drop bin reads a zero row back
        out_buf = torch.cat([out_buf, out_buf.new_zeros((1, D))])

    # combine: each (token, choice) result weighted by its gate, summed over k
    gathered = out_buf.index_select(0, flat_idx)  # (N*k, D)
    weighted = gathered * top_p.reshape(-1, 1).to(gathered.dtype)
    y = weighted.view(N, k, D).sum(dim=1)
    return y.view(B, S, D), aux
