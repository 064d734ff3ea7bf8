"""Wrappers of the Hopper paged attention kernel (csrc/paged_tree_attention.cu).

Counterparts of the Pallas TPU kernels ``paged_tree_attention`` and
``ragged_paged_tree_attention`` in src/repro/kernels/tree_attention.py, in
the engine layout, reading one layer of the pool's native arena
(NBLK, block, Hkv, D) through the block table.  The plain PyTorch versions
are ``kernels.ref.paged_tree_attention_ref`` and
``kernels.ref.ragged_tree_attention_ref``.

These functions only launch: they take CUDA tensors and raise on anything
the kernel does not take (CPU tensors included).  ``kernels.ops`` is the
dispatch by device.  ``paged_tree_attention.launches`` and
``ragged_paged_tree_attention.launches`` count the calls of each (one call
is one launch, or a split pass and its combine past 4096 slots).  Their
schedule is ``tree_attention.launch_schedule``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.tree_attention import launch_schedule, mask_vectorizable, partials

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 48, 64, 128, 256)  # the instances compiled in csrc/paged_tree_attention.cu
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 14 + [ctypes.c_void_p]


def _check(kernel: str, q, k_arena, v_arena, tbl, mask, tensors: dict) -> None:
    build.check_cuda_tensors(kernel, tensors)
    if q.dtype not in _DTYPES:
        raise ValueError(f"{kernel}: dtype {q.dtype} not supported (bfloat16, float32)")
    if k_arena.dtype != q.dtype or v_arena.dtype != q.dtype:
        raise ValueError(f"{kernel}: q, k, v dtypes differ ({q.dtype}, {k_arena.dtype}, {v_arena.dtype})")
    if mask.dtype != torch.bool or tbl.dtype != torch.int32:
        raise ValueError(f"{kernel}: mask must be bool and tbl int32, got {mask.dtype}, {tbl.dtype}")
    if k_arena.dim() != 4 or v_arena.shape != k_arena.shape or tbl.dim() != 2:
        raise ValueError(f"{kernel}: expected k/v arenas (NBLK, block, Hkv, D) and tbl (B, nb); got "
                         f"{tuple(k_arena.shape)}, {tuple(v_arena.shape)}, {tuple(tbl.shape)}")
    H, D = q.shape[-2], q.shape[-1]
    Hkv = k_arena.shape[2]
    if k_arena.shape[3] != D or H % Hkv:
        raise ValueError(f"{kernel}: arena {tuple(k_arena.shape)} does not fit {H} heads of dim {D}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {D} not compiled (have {_HEAD_DIMS})")
    if min(q.numel(), tbl.numel()) == 0:
        raise ValueError(f"{kernel}: empty problem q {tuple(q.shape)}, tbl {tuple(tbl.shape)}")
    if k_arena.data_ptr() % 16 or v_arena.data_ptr() % 16:
        raise ValueError(f"{kernel}: k and v must start on a 16-byte boundary (16-byte loads)")


def _launch(kernel, q, k_arena, v_arena, tbl, owner, mask, R, T, Bm) -> torch.Tensor:
    H, D = q.shape[-2], q.shape[-1]
    block, Hkv = k_arena.shape[1], k_arena.shape[2]
    S = tbl.shape[1] * block
    out = torch.empty_like(q)
    tq, gh, split_slots, n_split = launch_schedule(H, Hkv, S, D)
    with torch.cuda.device(q.device):
        part_ml, part_acc, _keep = partials(n_split, R, H, D, q.device)
        stream = torch.cuda.current_stream().cuda_stream
        fn = build.function("paged_tree_attention", "paged_tree_attention_launch", _ARGTYPES)
        code = fn(q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), tbl.data_ptr(),
                  None if owner is None else owner.data_ptr(), mask.data_ptr(), out.data_ptr(), part_ml, part_acc,
                  R, T, H, Hkv, block, tbl.shape[1], D, Bm, tq, gh, split_slots, n_split,
                  mask_vectorizable(mask, S), _DTYPES[q.dtype], stream)
    build.check_launch("paged_tree_attention", code)
    return out


def paged_tree_attention(q: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
                         tbl: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Padded tree attention over a paged arena, on the card.

    q (B, T, H, D); k_arena, v_arena (NBLK, block, Hkv, D); tbl (B, nb)
    int32, -1 = unmapped; mask (B or 1, T, nb * block) bool over logical
    slots.  Returns (B, T, H, D) in q's dtype."""
    kernel = "paged_tree_attention"
    _check(kernel, q, k_arena, v_arena, tbl, mask,
           {"q": q, "k_arena": k_arena, "v_arena": v_arena, "tbl": tbl, "mask": mask})
    if q.dim() != 4 or mask.dim() != 3:
        raise ValueError(f"{kernel}: expected q (B, T, H, D) and mask (Bm, T, S); got "
                         f"{tuple(q.shape)}, {tuple(mask.shape)}")
    B, T = q.shape[:2]
    S = tbl.shape[1] * k_arena.shape[1]
    if tbl.shape[0] != B or mask.shape[0] not in (1, B) or mask.shape[1:] != (T, S):
        raise ValueError(f"{kernel}: tbl {tuple(tbl.shape)} and mask {tuple(mask.shape)} do not fit "
                         f"q {tuple(q.shape)} with S = {S}")
    out = _launch(kernel, q, k_arena, v_arena, tbl, None, mask, B * T, T, mask.shape[0])
    paged_tree_attention.launches += 1
    return out


def ragged_paged_tree_attention(q: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
                                tbl: torch.Tensor, owner: torch.Tensor,
                                mask: torch.Tensor) -> torch.Tensor:
    """Ragged node-major tree attention over a paged arena, on the card.

    q (N, H, D) flat nodes of every stream's tree; k_arena, v_arena
    (NBLK, block, Hkv, D); tbl (B, nb) int32, -1 = unmapped; owner (N,)
    int32 pool row of each node, in [0, B), or -1 for a padding lane (its
    output is zero and it reads nothing); mask (N, nb * block) bool over
    the owner row's logical slots.  Returns (N, H, D) in q's dtype."""
    kernel = "ragged_paged_tree_attention"
    _check(kernel, q, k_arena, v_arena, tbl, mask,
           {"q": q, "k_arena": k_arena, "v_arena": v_arena, "tbl": tbl, "owner": owner, "mask": mask})
    if q.dim() != 3 or mask.dim() != 2 or owner.dim() != 1 or owner.dtype != torch.int32:
        raise ValueError(f"{kernel}: expected q (N, H, D), owner (N,) int32 and mask (N, S); got "
                         f"{tuple(q.shape)}, {tuple(owner.shape)} {owner.dtype}, {tuple(mask.shape)}")
    N = q.shape[0]
    S = tbl.shape[1] * k_arena.shape[1]
    if owner.shape[0] != N or mask.shape != (N, S):
        raise ValueError(f"{kernel}: owner {tuple(owner.shape)} and mask {tuple(mask.shape)} do not "
                         f"fit {N} nodes with S = {S}")
    out = _launch(kernel, q, k_arena, v_arena, tbl, owner, mask, N, 1, 1)
    ragged_paged_tree_attention.launches += 1
    return out


paged_tree_attention.launches = 0
ragged_paged_tree_attention.launches = 0
