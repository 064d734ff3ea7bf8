"""Mixture-of-Experts layer with sort-free dropless dispatch, inference only.

The counterpart of src/repro/models/moe.py (``init_moe``, ``moe_capacity``,
``moe_apply``).  Tokens are scattered into per-expert buffers (E, C, D) at
computed slot indices (the rank of each (token, choice) within its expert),
the expert SwiGLU runs as one batched product per expert weight over
(E, C, D), and the outputs are gathered back weighted by the renormalised
gates.

Routing is DROPLESS: C is the call's token count, so every (token, choice)
has its own slot and a token's output never depends on the tokens that share
its call.  The batched engine's exactness (padded and ragged passes, idle
and padding lanes) rests on this.  The JAX package rounds C up to a multiple
of 8 for TPU tiling; the extra slots are zero rows whose outputs are never
gathered, so C = N here gives the same result.

Nothing here reads a tensor back to the host (no ``.item()``, no boolean
indexing, no loop over per-expert counts, no ``bincount``): an MoE layer
enqueues its work like any other, so the pipelined engine's dispatch never
stalls on it.  Training's capacity-factor dispatch (``train=True``) is not
ported.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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


def moe_capacity(n_tokens: int, cfg, train: bool = False) -> int:
    """Per-expert buffer size.  Dropless inference: the top_k experts of one
    token are distinct, so no expert takes more than n_tokens."""
    if train:
        raise NotImplementedError("MoE capacity-factor training dispatch is not ported: "
                                  "ROADMAP queue 1 item 13")
    return n_tokens


def moe_apply(p: dict, cfg, x: torch.Tensor, train: bool = False):
    """x (B, S, D) -> (y (B, S, D), aux (scalar fp32 load-balance loss))."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * S
    C = moe_capacity(N, cfg, train)
    xf = x.reshape(N, D)

    logits = xf.float() @ p["router"]  # (N, E), fp32
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)  # (N, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)  # renormalised gates

    # load-balance auxiliary loss (Switch-style), as the JAX package returns it
    me = probs.mean(dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, top_e[:, 0], torch.ones(N, dtype=torch.float32, device=x.device)) / N
    aux = E * torch.sum(me * ce)

    # slot = rank of each (token, choice) within its expert, in flat order: a
    # stable sort groups the expert ids, a cumulative count gives group starts
    flat_e = top_e.reshape(-1)  # (N*k,)
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    hist = torch.zeros(E, dtype=torch.int64, device=x.device).index_add_(
        0, flat_e, torch.ones(n, dtype=torch.int64, device=x.device))
    starts = torch.cumsum(hist, 0) - hist
    rank_sorted = torch.arange(n, device=x.device) - starts[flat_e[order]]
    slot = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    flat_idx = flat_e * C + slot  # distinct: rank < the expert's load <= N = C

    # dispatch: every index is distinct, so a copy equals JAX's scatter-add into zeros
    src = xf.repeat_interleave(k, dim=0)  # (N*k, D)
    buf = x.new_zeros((E * C, D)).index_copy_(0, flat_idx, src).view(E, C, D)

    # expert FFN: batched SwiGLU, one product per expert weight
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"]).view(E * C, D)

    # combine: each (token, choice) result weighted by its gate, summed over k
    gathered = out_buf.index_select(0, flat_idx)  # (N*k, D)
    weighted = gathered * top_p.reshape(-1, 1).to(gathered.dtype)
    y = weighted.view(N, k, D).sum(dim=1)
    return y.view(B, S, D), aux
