"""Serving steps: the lockstep ring-compaction commit.

The counterpart of the lockstep branch of ``make_pool_commit_step`` in
src/repro/serving/serve_step.py (and ``next_pow2``).  The per-stream and
paged branches, which the JAX package runs through the ``commit_kv``
kernel, come with the batched engine (ROADMAP queue 1 item 5).
"""
from __future__ import annotations

import torch


def next_pow2(n: int) -> int:
    """Smallest power of two >= n — the shape-bucketing rule shared by both
    engines."""
    p = 1
    while p < n:
        p *= 2
    return p


def make_pool_commit_step(Tpad: int):
    """Post-verification commit of a single-stream lockstep cache.

    Returned fn: (cache, node_path, path_len, C) -> cache
      node_path (P,) int tensor : accepted tree-node indices, padded
      path_len  int             : number of real entries
      C         int             : committed target length before the block
                                  (the pending root sits at ring slot C % smax)

    Moves KV lanes (C + n_j) % smax -> (C + j) % smax for j = 1..path_len,
    invalidates the Tpad block slots, rewrites pos over the surviving run and
    sets len to C + 1 + path_len (the contract in src/repro/models/cache.py).
    k/v are moved in place: every source lane is gathered before any
    destination is written, and padding entries are identity copies of the
    root slot.  pos and len come back as new tensors.  (The JAX version
    also takes the model config, to choose its commit kernel.)
    """

    def commit(cache, node_path, path_len: int, C: int):
        a = cache["attn"]
        k, v, pos = a["k"], a["v"], a["pos"]
        if pos.dim() != 1:
            raise NotImplementedError("per-stream and paged pools: ROADMAP queue 1 item 5")
        dev = pos.device
        smax = pos.shape[0]
        P = node_path.shape[-1]
        j = torch.arange(P, device=dev)
        t = torch.arange(Tpad, device=dev)
        jj = torch.arange(P + 1, device=dev)
        valid = j < path_len
        root = C % smax
        src = torch.where(valid, (C + node_path.long()) % smax, root)
        dst = torch.where(valid, (C + 1 + j) % smax, root)
        k.index_copy_(2, dst, k.index_select(2, src))
        v.index_copy_(2, dst, v.index_select(2, src))
        new_pos = pos.clone()
        new_pos[(C + t) % smax] = -1
        keep_valid = jj <= path_len
        keep_slots = torch.where(keep_valid, (C + jj) % smax, root)
        keep_vals = torch.where(keep_valid, C + jj, C).to(pos.dtype)
        new_pos[keep_slots] = keep_vals
        cache = dict(cache)
        cache["attn"] = {"k": k, "v": v, "pos": new_pos,
                         "len": torch.tensor(C + 1 + path_len, dtype=torch.int32, device=dev)}
        return cache

    return commit
