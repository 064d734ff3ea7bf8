"""KV cache structures: the lockstep ring of src/repro/models/cache.py.

Attention caches are ring buffers of size ``Smax``: slot = position % Smax,
with absolute positions stored so masks can express causality uniformly.
This module holds the lockstep layout only (``len`` and ``pos`` shared
across the batch, as the single-stream engine uses them):

    attn:  k, v: (L, B, Smax, Hkv, hd);  pos: (Smax,) int32;  len: () int32

The per-stream and paged layouts and the stream algebra come with the
batched engine (ROADMAP queue 1 item 5).  The ring-compaction commit
contract is documented in src/repro/models/cache.py and implemented by
serving/serve_step.make_pool_commit_step.

Unlike the JAX package, ``append_layer_kv`` writes the new K/V into the
cache in place (``index_copy_``): a forward pass mutates the k/v tensors of
the cache it is given, while ``pos`` and ``len`` come back as new tensors.
A caller that still needs the cache as it was before a pass gives the pass
a copy (``clone_cache``).
"""
from __future__ import annotations

import torch


def init_attn_cache(cfg, n_layers: int, batch: int, smax: int, dtype: torch.dtype,
                    device) -> dict:
    hd = cfg.hd
    return {
        "k": torch.zeros((n_layers, batch, smax, cfg.n_kv_heads, hd), dtype=dtype, device=device),
        "v": torch.zeros((n_layers, batch, smax, cfg.n_kv_heads, hd), dtype=dtype, device=device),
        "pos": torch.full((smax,), -1, dtype=torch.int32, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_slots(length: torch.Tensor, T: int, smax: int) -> torch.Tensor:
    """(T,) ring slots of T tokens appended after a scalar length."""
    return (length + torch.arange(T, dtype=torch.int32, device=length.device)) % smax


def append_layer_kv(k_cache: torch.Tensor, v_cache: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor, slots: torch.Tensor):
    """k_cache: (B, Smax, Hkv, hd); k_new: (B, T, Hkv, hd); slots: (T,).

    Writes in place (the JAX package returns new arrays) and returns the
    same two tensors."""
    idx = slots.long()
    k_cache.index_copy_(1, idx, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v_new.to(v_cache.dtype))
    return k_cache, v_cache


def attn_mask_from_pos(pos: torch.Tensor, q_positions: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Mask: slot valid iff 0 <= pos[s] <= q_pos[t] (and within the window
    when sliding).  pos: (Smax,); q_positions: (T,) absolute positions of
    the queries.  Returns (1, 1, T, Smax)."""
    s = pos[None, :]
    t = q_positions[:, None]
    m = (s >= 0) & (s <= t)
    if window:
        m = m & (s > t - window)
    return m[None, None]


def tree_mask_from_pos(pos: torch.Tensor, q_positions: torch.Tensor, anc: torch.Tensor,
                       self_slots: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Tree-pass mask over cache slots that now *contain* the tree tokens.

    The T tree tokens were appended into ``self_slots``; a tree token may
    attend to (a) any older cache slot per the causal/window rule against
    the branch-context boundary, and (b) its tree ancestors (anc, (T, T) or
    (Ba, T, T) sharing one slot table, including self).  Returns
    (1, 1, T, Smax) or (Ba, 1, T, Smax).
    """
    base = attn_mask_from_pos(pos, q_positions, window)[0, 0]  # (T, Smax)
    idx = self_slots.long()
    # cut out the tree's own slots from the causal rule, then re-add ancestors
    is_self = torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
    is_self[idx] = True
    base = base & ~is_self[None, :]
    if anc.dim() == 3:
        tree_part = torch.zeros((anc.shape[0],) + base.shape, dtype=torch.bool, device=pos.device)
        tree_part[:, :, idx] = anc.bool()
        return (base[None] | tree_part)[:, None]
    tree_part = torch.zeros(base.shape, dtype=torch.bool, device=pos.device)
    tree_part[:, idx] = anc.bool()
    return (base | tree_part)[None, None]


def fork_streams(cache: dict, K: int) -> dict:
    """Replicate the cache's stream rows K times along the batch axis (row b
    maps to rows b*K .. b*K+K-1).  The lockstep pos/len stay shared.  The
    forked k/v are new tensors, so passes over the fork leave the parent's
    k/v untouched."""
    a = cache["attn"]
    out = dict(cache)
    out["attn"] = {**a, "k": a["k"].repeat_interleave(K, dim=1),
                   "v": a["v"].repeat_interleave(K, dim=1)}
    return out


def clone_cache(cache: dict) -> dict:
    """A copy whose k/v a forward pass may write without touching ``cache``."""
    return {key: ({n: t.clone() for n, t in val.items()} if isinstance(val, dict) else val.clone())
            for key, val in cache.items()}
