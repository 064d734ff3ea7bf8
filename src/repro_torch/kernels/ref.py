"""Plain PyTorch versions of the package's kernels.

The counterpart of src/repro/kernels/ref.py.  The CPU tests use these, and
chip_smoke.py holds each CUDA kernel against its plain version on the card.
On the main path they run only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def tree_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Masked attention in the engine layout.

    q (B, T, H, D); k, v (B, S, Hkv, D); mask (Bm, T, S) bool with Bm in
    {1, B}.  Returns (B, T, H, D) in q's dtype.  Scores and softmax in fp32
    with the finite NEG_INF, so a fully masked row gives the mean of V."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, T, Hkv, H // Hkv, D)
    s = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) / (D ** 0.5)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    w = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgts,bshd->bthgd", w, v.float())
    return out.reshape(B, T, H, D).to(q.dtype)


def commit_kv_ref(k: torch.Tensor, v: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    """Gather-then-scatter ring-compaction commit, IN PLACE.

    k, v (L, B, Smax, Hkv, hd); src, dst (B, P) int slots.  Every source
    lane is read before any destination is written.  An entry with
    src == dst (padding) or with an index outside [0, Smax) moves nothing,
    as in the kernel.  Writes into k and v and returns them."""
    smax = k.shape[2]
    src, dst = src.long(), dst.long()
    moves = (src != dst) & (src >= 0) & (src < smax) & (dst >= 0) & (dst < smax)
    b, j = moves.nonzero(as_tuple=True)
    s, d = src[b, j], dst[b, j]
    kg, vg = k[:, b, s], v[:, b, s]
    k[:, b, d] = kg
    v[:, b, d] = vg
    return k, v


def paged_gather_kv_ref(k_arena: torch.Tensor, v_arena: torch.Tensor, tbl: torch.Tensor):
    """The logical per-stream view of a paged arena.

    k_arena, v_arena (NBLK, block, Hkv, hd) or (L, NBLK, block, Hkv, hd);
    tbl (B, max_blocks) int, -1 = unmapped (clamped to the trash block 0).
    Returns new tensors (B, max_blocks * block, Hkv, hd), with a leading L
    when the arena has one.  Unmapped lanes hold trash content: callers
    mask them (their pos is -1)."""
    phys = tbl.long().clamp_min(0)
    B, nb = phys.shape
    if k_arena.dim() == 5:
        L, block = k_arena.shape[0], k_arena.shape[2]
        return (k_arena[:, phys].reshape((L, B, nb * block) + k_arena.shape[3:]),
                v_arena[:, phys].reshape((L, B, nb * block) + v_arena.shape[3:]))
    block = k_arena.shape[1]
    return (k_arena[phys].reshape((B, nb * block) + k_arena.shape[2:]),
            v_arena[phys].reshape((B, nb * block) + v_arena.shape[2:]))


def paged_tree_attention_ref(q: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
                             tbl: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked attention over a paged arena: the block-table gather, then
    ``tree_attention_ref``.  q (B, T, H, D); arenas (NBLK, block, Hkv, D);
    tbl (B, nb); mask (Bm, T, nb * block).  Returns (B, T, H, D)."""
    kd, vd = paged_gather_kv_ref(k_arena, v_arena, tbl)
    return tree_attention_ref(q, kd, vd, mask)


def ragged_tree_attention_ref(q: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
                              tbl: torch.Tensor, owner: torch.Tensor,
                              mask: torch.Tensor) -> torch.Tensor:
    """Ragged node-major attention over a paged arena.  q (N, H, D);
    arenas (NBLK, block, Hkv, D); tbl (B, nb); owner (N,) pool row of each
    node, -1 for a padding lane; mask (N, nb * block) over the owner row's
    logical slots.  Each node attends over its owner row's gathered view; a
    padding lane's output is zero.  Returns (N, H, D)."""
    own = owner.long()
    kd, vd = paged_gather_kv_ref(k_arena, v_arena, tbl[own.clamp_min(0)])  # (N, S, Hkv, D)
    out = tree_attention_ref(q[:, None], kd, vd, mask[:, None])[:, 0]
    return torch.where((own >= 0)[:, None, None], out, torch.zeros((), dtype=out.dtype, device=out.device))


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
                         window: int = 0) -> torch.Tensor:
    """Single-query decode attention, validity from the cache length.

    q (B, 1, H, D); k, v (B, S, Hkv, D); lengths (B,) int.  Slot s of row b
    is valid iff s < lengths[b] (and, with a window, s >= lengths[b] -
    window); there is no mask tensor.  A row with no valid slot (length 0)
    gets the mean of V over all S slots.  Returns (B, 1, H, D) in q's
    dtype."""
    S = k.shape[1]
    slot = torch.arange(S, device=q.device)[None, :]
    ln = lengths.long()[:, None]
    valid = slot < ln
    if window:
        valid = valid & (slot >= ln - window)
    return tree_attention_ref(q, k, v, valid[:, None, :])


def paged_decode_attention_ref(q: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
                               tbl: torch.Tensor, lengths: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Decode attention over a paged arena: the block-table gather (-1 reads
    the trash block 0), then ``decode_attention_ref``.  q (B, 1, H, D);
    arenas (NBLK, block, Hkv, D); tbl (B, nb); lengths (B,).  Returns
    (B, 1, H, D)."""
    kd, vd = paged_gather_kv_ref(k_arena, v_arena, tbl)
    return decode_attention_ref(q, kd, vd, lengths, window)
