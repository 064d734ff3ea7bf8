"""Logit/probability warping: temperature + nucleus (top-p) sampling.

The counterpart of src/repro/sampling/warp.py.  All verification works on
*warped* target and draft distributions; losslessness is always w.r.t. the
warped target distribution.  (``sample_categorical`` comes with on-device
verification, ROADMAP queue 1 item 11.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def warp_logits(logits: torch.Tensor, temperature: float = 1.0, top_p: float = 1.0) -> torch.Tensor:
    """Apply temperature then nucleus filtering to logits.  Returns fp32
    probabilities over the last axis.  temperature == 0 is greedy (one-hot
    argmax)."""
    if temperature == 0.0:
        return F.one_hot(logits.argmax(dim=-1), logits.shape[-1]).float()
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return warp_probs(probs, top_p=top_p)


def warp_probs(probs: torch.Tensor, top_p: float = 1.0) -> torch.Tensor:
    """Nucleus-filter a probability vector (last axis), renormalising.

    Keeps the smallest prefix of the sorted distribution whose mass is
    >= top_p (the token that crosses the threshold is kept).  Ties sort as
    in the JAX version: a stable ascending sort, reversed.
    """
    if top_p >= 1.0:
        return probs
    sort_idx = torch.argsort(probs, dim=-1, stable=True).flip(-1)
    sorted_p = torch.gather(probs, -1, sort_idx)
    csum = torch.cumsum(sorted_p, dim=-1)
    # keep tokens whose *preceding* cumulative mass is < top_p
    keep_sorted = (csum - sorted_p) < top_p
    keep = torch.zeros_like(keep_sorted).scatter(-1, sort_idx, keep_sorted)
    filtered = torch.where(keep, probs, 0.0)
    return filtered / filtered.sum(dim=-1, keepdim=True)
