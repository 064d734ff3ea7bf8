"""Serving steps: the pool steps of the continuous-batching engine and the
ring-compaction commit.

The counterpart of the pool steps of src/repro/serving/serve_step.py
(``StagingBuffers``, ``make_pool_decode_step``, ``make_pool_locked_step``,
``device_ancestor_mask``, ``make_pool_tree_step``,
``make_pool_ragged_tree_step``, ``make_pool_commit_step``,
``make_group_commit_step``, ``next_pow2``).
The steps are plain functions (PyTorch runs eagerly; nothing is jitted or
donated).  Per-step host-to-device traffic is small index arrays: ancestor
masks are composed on the device from parent pointers, and the commit is
driven by (node_path, path_len, C) tables.

Where these write in place: every step's forward pass writes its K/V into
the pool's k/v (models/cache.py), and the commit moves KV lanes in place
through ``kernels.ops.pool_commit_kv``.  pos/len come back as new tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ops import pool_commit_kv
from repro_torch.models.cache import ancestor_closure, merge_streams, paged_phys_slots
from repro_torch.models.transformer import forward


def next_pow2(n: int) -> int:
    """Smallest power of two >= n — the shape-bucketing rule shared by both
    engines."""
    p = 1
    while p < n:
        p *= 2
    return p


_TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.bool_): torch.bool}


class StagingBuffers:
    """Reusable host staging buffers for the per-step index arrays.

    On a CUDA engine the buffers are pinned, so ``upload`` copies them to
    the card without blocking the host.  Such a copy runs when the stream
    reaches it, so a buffer must not be refilled before then: ``banks`` > 1
    double-buffers the staging, and ``flip()`` (each pipelined
    ``begin_step``) rotates to the next bank, so refilling step i+1's
    arrays never touches the bank step i's copies read.  Within one bank
    every refill happens after the engine has read a later result of the
    same stream back to the host (each phase ends with one), so the copies
    from it have run.
    """

    def __init__(self, device, banks: int = 1):
        if banks < 1:
            raise ValueError(f"banks must be >= 1, got {banks}")
        self.device = torch.device(device)
        self._banks = banks
        self._bank = 0
        self._bufs: dict = {}

    def flip(self) -> None:
        """Rotate to the next bank (a pipelined ``begin_step`` boundary)."""
        self._bank = (self._bank + 1) % self._banks

    def get(self, name: str, shape: tuple, dtype, fill=0) -> np.ndarray:
        """A ``fill``-initialised buffer of the given shape from the current
        bank, reused across steps with the same shape bucket."""
        key = (self._bank, name, shape)
        buf = self._bufs.get(key)
        if buf is None:
            pinned = self.device.type == "cuda"
            buf = self._bufs[key] = torch.empty(shape, dtype=_TORCH_DTYPES[np.dtype(dtype)],
                                                pin_memory=pinned).numpy()
        buf.fill(fill)
        return buf

    def upload(self, buf: np.ndarray) -> torch.Tensor:
        """The buffer's content as a tensor on the engine's device (a copy)."""
        if self.device.type == "cpu":
            return torch.tensor(buf)
        return torch.from_numpy(buf).to(self.device, non_blocking=True)


def make_pool_decode_step(cfg):
    """(params, pool_cache, tokens (B, Tpad), lens (B,)) ->
    (logits, cache, hidden).

    Padded decode over a per-stream pool: row b's tokens beyond lens[b] are
    written but invalidated (pos = -1), so heterogeneous per-stream deltas
    advance in one call."""

    def step(params, cache, tokens, lens):
        logits, new_cache, ex = forward(params, cfg, tokens, mode="decode", cache=cache, lens=lens)
        return logits, new_cache, ex["hidden"]

    return step


def make_pool_locked_step(cfg):
    """(params, pool_cache, tokens (B, 1), keep (B,)) -> (logits, cache).

    One lockstep token per stream; rows with keep=False keep their prior
    pos/len and recurrent state (merge_streams), their K/V write stays in
    a lane barred by pos = -1."""

    def step(params, cache, tokens, keep):
        logits, new_cache, _ = forward(params, cfg, tokens, mode="decode", cache=cache)
        return logits, merge_streams(new_cache, cache, keep)

    return step


def device_ancestor_mask(parents: torch.Tensor) -> torch.Tensor:
    """Per-row ancestor-or-self masks composed on the device from parent
    pointers.  parents (B, T) int, -1 for roots and padding nodes (isolated
    roots).  Returns (B, T, T) bool, mask[b, i, j] iff j is an ancestor of
    i or i == j: ``core.trees.tree_ancestor_mask`` per row."""
    B, T = parents.shape
    idx = torch.arange(T, device=parents.device)
    direct = (idx[None, None, :] == idx[None, :, None]) | (idx[None, None, :] == parents.long()[:, :, None])
    return ancestor_closure(direct)


def make_pool_tree_step(cfg):
    """(params, pool_cache, tokens (B, Tpad), parents (B, Tpad), keep (B,))
    -> (logits, cache, hidden).

    The padded continuous-batching target pass: per-row tree topologies
    over a per-stream pool, ancestor masks composed on the device, rows
    with keep=False frozen (merge_streams).  Padding nodes carry parent = -1
    and are invalidated at commit."""

    def tree_step(params, cache, tokens, parents, keep):
        anc = device_ancestor_mask(parents)
        logits, new_cache, ex = forward(params, cfg, tokens, mode="tree", cache=cache, anc=anc)
        return logits, merge_streams(new_cache, cache, keep), ex["hidden"]

    return tree_step


def make_pool_ragged_tree_step(cfg):
    """(params, pool_cache, toks (Npad,), owner, parent, depth, local,
    counts) -> (logits (Npad, V), cache, hidden (Npad, d)).

    The RAGGED target pass: every active stream's tree flattened into one
    node-major buffer.  Node j of a stream lands in the ring slot padded
    column j would, so the commit is shared between both layouts.  Idle
    rows advance by counts = 0; padding lanes write the trash block only."""

    def ragged_tree_step(params, cache, toks, owner, parent, depth, local, counts):
        logits, new_cache, ex = forward(
            params, cfg, toks[None], mode="tree", cache=cache,
            ragged={"owner": owner, "parent": parent, "depth": depth, "local": local, "counts": counts},
        )
        return logits[0], new_cache, ex["hidden"][0]

    return ragged_tree_step


def make_pool_commit_step(Tpad: int):
    """Post-verification commit over the cache of either engine.

    Per-stream pool (ring or paged): fn(cache, node_path (B, P), path_len
    (B,), C (B,), active (B,) bool) -> cache.  Moves KV lanes
    (C + n_j) % smax -> (C + 1 + j) % smax for the accepted path of every
    active row in ONE ``pool_commit_kv`` over all layers, invalidates the
    Tpad block slots, rewrites pos over the surviving run and sets len to
    C + 1 + path_len (the contract in src/repro/models/cache.py).  Padded
    and idle entries are identity copies of the row's root slot.  A paged
    pool translates src/dst through the block tables and commits the arena
    as one row of B * P entries (rows own disjoint blocks; idle entries
    land in the trash block with src == dst).  Inactive rows keep pos/len.

    Lockstep single-stream cache: fn(cache, node_path (P,), path_len int,
    C int) -> cache, the slot arithmetic shared across the batch.

    k/v are moved in place; pos and len come back as new tensors.  (The JAX
    version also takes the model config, to choose its commit kernel.)
    """

    def commit(cache, node_path, path_len, C, active=None):
        a = cache["attn"]
        k, v, pos = a["k"], a["v"], a["pos"]
        dev = pos.device
        smax = pos.shape[-1]
        P = node_path.shape[-1]
        j = torch.arange(P, device=dev)
        t = torch.arange(Tpad, device=dev)
        jj = torch.arange(P + 1, device=dev)
        if pos.dim() == 2:
            B = pos.shape[0]
            bidx = torch.arange(B, device=dev)[:, None]
            C = C.long()
            valid = j[None, :] < path_len[:, None]
            root = (C % smax)[:, None]
            src = torch.where(valid, (C[:, None] + node_path) % smax, root)
            dst = torch.where(valid, (C[:, None] + 1 + j[None, :]) % smax, root)
            if "block_tbl" in a:
                tbl = a["block_tbl"]
                block, nl = k.shape[2], k.shape[0]
                srcf = paged_phys_slots(tbl, src, block).reshape(1, -1).to(torch.int32)
                dstf = paged_phys_slots(tbl, dst, block).reshape(1, -1).to(torch.int32)
                pool_commit_kv(k.view((nl, 1, k.shape[1] * block) + k.shape[3:]),
                               v.view((nl, 1, v.shape[1] * block) + v.shape[3:]), srcf, dstf)
            else:
                pool_commit_kv(k, v, src.to(torch.int32), dst.to(torch.int32))
            new_pos = pos.clone()
            new_pos[bidx, (C[:, None] + t[None, :]) % smax] = -1
            keep_valid = jj[None, :] <= path_len[:, None]
            keep_slots = torch.where(keep_valid, (C[:, None] + jj[None, :]) % smax, root)
            keep_vals = torch.where(keep_valid, C[:, None] + jj[None, :], C[:, None])
            new_pos[bidx, keep_slots] = keep_vals.to(pos.dtype)
            new_pos = torch.where(active[:, None], new_pos, pos)
            new_len = torch.where(active, C + 1 + path_len, a["len"]).to(torch.int32)
        else:
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
            new_len = torch.tensor(C + 1 + path_len, dtype=torch.int32, device=dev)
        new_attn = {"k": k, "v": v, "pos": new_pos, "len": new_len}
        if "block_tbl" in a:
            new_attn["block_tbl"] = a["block_tbl"]
        return {**cache, "attn": new_attn}

    return commit


def make_group_commit_step(tpads: list[int]):
    """Grouped cross-shard commit: the shards' post-verification commits as
    ONE engine-level call.

    Builds one ``make_pool_commit_step(T)`` per shard (each with its own
    Tpad: shards bucket their speculation shapes independently) and applies
    them over tuples in shard order.  Returned fn: (caches, node_paths,
    path_lens, Cs, actives) -> caches, every argument a tuple in shard
    order with the per-shard contract of ``make_pool_commit_step``.

    The JAX version jits the group into one fused program that updates every
    shard's pool in place.  Each shard's pool here is its own tensors, so
    the group launches ``commit_kv`` once per shard: one engine-level commit
    call, as many kernel launches as shards.  The batched engines commit
    through it, a lone engine as a group of one."""
    fns = [make_pool_commit_step(T) for T in tpads]

    def group_commit(caches, node_paths, path_lens, Cs, actives):
        if len(caches) != len(fns):
            raise ValueError(f"{len(caches)} shard pools for a group of {len(fns)}")
        return tuple(fn(cache, npath, plen, C, act)
                     for fn, cache, npath, plen, C, act in zip(fns, caches, node_paths, path_lens, Cs, actives))

    return group_commit
