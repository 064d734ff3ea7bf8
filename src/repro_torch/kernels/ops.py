"""Engine-facing kernel entry points, dispatched by the tensors' device.

The counterpart of src/repro/kernels/ops.py.  A CPU tensor takes the plain
version (kernels/ref.py); a CUDA tensor launches the hand-written kernel,
which raises on anything it does not take.  There is no other fallback.

Unlike the TPU wrappers, these pad nothing (T to 8, S to a block multiple,
N to 8-row owner tiles, the decode query to 8 rows are TPU tiling rules),
replicate nothing (the kernels read KV head h // (H / Hkv) and broadcast a
(1, T, S) mask by indexing) and transpose no arena (the paged kernels read
the pool's native (NBLK, block, Hkv, D) layout through the block table).

The two decode entries have no engine caller, as in the JAX package (whose
engines send every masked pass to the tree kernels): the tests and
``chip_smoke.py`` reach them here.

The hand-written kernels have no backward.  Every wrapper refuses a CUDA
tensor that requires grad while grad mode is on (``refuse_grad``), before it
launches: its output would carry no ``grad_fn``, and a gradient through it
would be lost without a word.  Training takes the plain, differentiable
attention instead (``forward(..., train=True)``), as the JAX package trains
through XLA.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.commit_kv import commit_kv
from repro_torch.kernels.decode_attention import decode_attention, paged_decode_attention
from repro_torch.kernels.paged_tree_attention import paged_tree_attention, ragged_paged_tree_attention
from repro_torch.kernels.ref import (
    commit_kv_ref,
    decode_attention_ref,
    paged_decode_attention_ref,
    paged_tree_attention_ref,
    ragged_tree_attention_ref,
    tree_attention_ref,
)
from repro_torch.kernels.tree_attention import tree_attention


def refuse_grad(name: str, device_type: str, *tensors: torch.Tensor) -> None:
    """Raise if a kernel on ``device_type`` would be launched on a tensor
    that requires grad while grad mode is on.  Every wrapper calls it
    before its kernel; the CPU's plain versions are differentiable and
    never call it."""
    if device_type != "cpu" and torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: a {device_type} tensor requires grad, but the hand-written kernels have no "
            "backward; training takes the plain attention (forward(..., train=True)), as the JAX "
            "package trains through XLA")


def gqa_tree_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """q (B, T, H, D); k, v (B, S, Hkv, D); mask (B, T, S) or (1, T, S) bool.
    Returns (B, T, H, D)."""
    if q.device.type == "cpu":
        return tree_attention_ref(q, k, v, mask)
    refuse_grad("tree_attention", q.device.type, q, k, v)
    return tree_attention(q, k, v, mask)


def gqa_paged_tree_attention(q: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
                             tbl: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Tree attention over one layer of a paged pool.

    q (B, T, H, D); k_arena, v_arena (NBLK, block, Hkv, D); tbl
    (B, max_blocks) int32 (-1 = unmapped, read as the trash block); mask
    (B, T, S) or (1, T, S) bool over logical slots, S = max_blocks * block.
    Returns (B, T, H, D)."""
    if q.device.type == "cpu":
        return paged_tree_attention_ref(q, k_arena, v_arena, tbl, mask)
    refuse_grad("paged_tree_attention", q.device.type, q, k_arena, v_arena)
    return paged_tree_attention(q, k_arena, v_arena, tbl, mask)


def gqa_ragged_tree_attention(q: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
                              tbl: torch.Tensor, owner: torch.Tensor,
                              mask: torch.Tensor) -> torch.Tensor:
    """Ragged tree attention over one layer of a paged pool.

    q (N, H, D), the flat node-major buffer of every active stream's tree;
    k_arena, v_arena (NBLK, block, Hkv, D); tbl (B, max_blocks) int32;
    owner (N,) int32 pool row per node (the owner is per node: no
    alignment of segments), -1 for a padding lane, whose output is zero;
    mask (N, S) bool over the owner row's logical slots.  Returns
    (N, H, D)."""
    if q.device.type == "cpu":
        return ragged_tree_attention_ref(q, k_arena, v_arena, tbl, owner, mask)
    refuse_grad("ragged_paged_tree_attention", q.device.type, q, k_arena, v_arena)
    return ragged_paged_tree_attention(q, k_arena, v_arena, tbl, owner, mask)


def pool_commit_kv(k: torch.Tensor, v: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    """Ring-compaction commit over a per-stream KV pool, IN PLACE.

    k, v (L, B, Smax, Hkv, hd); src, dst (B, P) int32 slots (padding
    entries carry src == dst and move nothing, nor does an entry with an
    index outside [0, Smax)).  ``k[l, b, dst[b, j]] <- k[l, b, src[b, j]]``
    with every source read before any destination is written (the
    hazard-free contract of serving/serve_step.make_pool_commit_step).
    Returns (k, v)."""
    if k.device.type == "cpu":
        return commit_kv_ref(k, v, src, dst)
    refuse_grad("commit_kv", k.device.type, k, v)
    return commit_kv(k, v, src, dst)


def gqa_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Flash-decode: one query token per row against a dense cache.

    q (B, 1, H, D); k, v (B, S, Hkv, D); lengths (B,) int32: slot s of row b
    is valid iff s < lengths[b] (and s >= lengths[b] - window when window >
    0); a row with no valid slot gets the mean of V.  Returns (B, 1, H, D)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths, window)
    refuse_grad("decode_attention", q.device.type, q, k, v)
    return decode_attention(q, k, v, lengths, window=window)


def gqa_paged_decode_attention(q: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
                               tbl: torch.Tensor, lengths: torch.Tensor, *,
                               window: int = 0) -> torch.Tensor:
    """Flash-decode over one layer of a paged pool.

    q (B, 1, H, D); k_arena, v_arena (NBLK, block, Hkv, D); tbl
    (B, max_blocks) int32 (-1 = unmapped, read as the trash block); lengths
    (B,) int32 over logical slots, validity as in ``gqa_decode_attention``.
    Returns (B, 1, H, D)."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_arena, v_arena, tbl, lengths, window)
    refuse_grad("paged_decode_attention", q.device.type, q, k_arena, v_arena)
    return paged_decode_attention(q, k_arena, v_arena, tbl, lengths, window=window)
