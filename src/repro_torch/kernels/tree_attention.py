"""Wrapper of the Hopper ``tree_attention`` kernel (csrc/tree_attention.cu).

The counterpart of the Pallas TPU kernel ``tree_attention`` in
src/repro/kernels/tree_attention.py, in the engine layout: q (B, T, H, D),
k/v (B, S, Hkv, D), mask (Bm, T, S) bool with Bm in {1, B}.  GQA and the
mask broadcast are done by indexing inside the kernel.  The plain PyTorch
version of the same function is ``kernels.ref.tree_attention_ref``.

This function only launches: it takes CUDA tensors and raises on anything
the kernel does not take (CPU tensors included).  ``kernels.ops`` is the
dispatch by device.  ``tree_attention.launches`` counts the calls (one call
is one launch, or a split pass and its combine past 4096 slots).

``launch_schedule`` is the host's part of the design shared with the paged
kernels (csrc/tree_attention_body.cuh): how many query rows and heads a CTA
serves, and whether the keys are split over CTAs.  It reads shapes only,
never the mask or the owners, so a launch needs no host sync.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 48, 64, 128, 256)  # the instances compiled in csrc/tree_attention.cu
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13 + [ctypes.c_void_p]

MAX_SCORE_ROWS = 128  # query heads x query rows per CTA: 8 warps of one m16 tile (max_score_rows)
MAX_QUERY_ROWS = 32   # query rows per CTA (one 32-key mask word each in shared memory)
SPLIT_ABOVE = 4096    # caches longer than this split their keys over CTAs
SPLIT_SLOTS = 2048    # keys per split then
CHUNK = 32            # keys per staged chunk


def max_score_rows(D: int) -> int:
    """Score rows a CTA holds at head_dim D: MAX_SCORE_ROWS, or half at
    D 256, whose fp32 queries and staged K/V of 128 rows would not fit the
    card's 227 KB of shared memory (csrc/tree_attention_body.cuh
    ``max_rows``)."""
    return MAX_SCORE_ROWS if D <= 128 else MAX_SCORE_ROWS // 2


def launch_schedule(H: int, Hkv: int, S: int, D: int = 128) -> tuple[int, int, int, int]:
    """(tq, gh, split_slots, n_split) of a launch over S key slots.

    A CTA serves gh query heads of one KV head (all G = H / Hkv unless G
    exceeds max_score_rows(D)) for a tile of up to tq query rows, gh * tq <=
    max_score_rows(D).  At S <= SPLIT_ABOVE the keys are one range (S rounded
    up to whole chunks) and a call is one launch.  Past it they split into
    ranges of SPLIT_SLOTS slots and a combine launch merges them.  Shapes
    only: never the mask nor the owners."""
    rows = max_score_rows(D)
    gh = min(H // Hkv, rows)
    tq = max(1, min(MAX_QUERY_ROWS, rows // gh))
    if S <= SPLIT_ABOVE:
        return tq, gh, -(-S // CHUNK) * CHUNK, 1
    return tq, gh, SPLIT_SLOTS, -(-S // SPLIT_SLOTS)


def partials(n_split: int, rows: int, H: int, D: int, device) -> tuple[int | None, int | None, tuple]:
    """The fp32 (m, l) and acc workspace of a split launch, as (ptr, ptr,
    keep-alive tensors); null pointers when the launch has one split."""
    if n_split == 1:
        return None, None, ()
    ml = torch.empty(n_split * rows * H * 2, dtype=torch.float32, device=device)
    acc = torch.empty(n_split * rows * H * D, dtype=torch.float32, device=device)
    return ml.data_ptr(), acc.data_ptr(), (ml, acc)


def mask_vectorizable(mask: torch.Tensor, S: int) -> int:
    """1 when the kernel may read mask rows with 16-byte loads."""
    return int(S % 16 == 0 and mask.data_ptr() % 16 == 0)


def tree_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Masked attention on the card.  Returns (B, T, H, D) in q's dtype."""
    build.check_cuda_tensors("tree_attention", {"q": q, "k": k, "v": v, "mask": mask})
    if q.dtype not in _DTYPES:
        raise ValueError(f"tree_attention: dtype {q.dtype} not supported (bfloat16, float32)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"tree_attention: q, k, v dtypes differ ({q.dtype}, {k.dtype}, {v.dtype})")
    if mask.dtype != torch.bool:
        raise ValueError(f"tree_attention: mask must be bool, got {mask.dtype}")
    if q.dim() != 4 or k.dim() != 4 or mask.dim() != 3:
        raise ValueError("tree_attention: expected q (B, T, H, D), k/v (B, S, Hkv, D), "
                         f"mask (Bm, T, S); got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(mask.shape)}")
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"tree_attention: k/v {tuple(k.shape)}, {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if H % Hkv:
        raise ValueError(f"tree_attention: {H} query heads are not a multiple of {Hkv} KV heads")
    if mask.shape[0] not in (1, B) or mask.shape[1:] != (T, S):
        raise ValueError(f"tree_attention: mask {tuple(mask.shape)} does not fit ({B} or 1, {T}, {S})")
    if D not in _HEAD_DIMS:
        raise ValueError(f"tree_attention: head_dim {D} not compiled (have {_HEAD_DIMS})")
    if min(B, T, S) == 0:
        raise ValueError(f"tree_attention: empty problem B={B} T={T} S={S}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("tree_attention: k and v must start on a 16-byte boundary (16-byte loads)")
    out = torch.empty_like(q)
    tq, gh, split_slots, n_split = launch_schedule(H, Hkv, S, D)
    with torch.cuda.device(q.device):
        part_ml, part_acc, _keep = partials(n_split, B * T, H, D, q.device)
        stream = torch.cuda.current_stream().cuda_stream
        fn = build.function("tree_attention", "tree_attention_launch", _ARGTYPES)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(), part_ml, part_acc,
                  B, T, H, Hkv, S, D, mask.shape[0], tq, gh, split_slots, n_split,
                  mask_vectorizable(mask, S), _DTYPES[q.dtype], stream)
    build.check_launch("tree_attention", code)
    tree_attention.launches += 1
    return out


tree_attention.launches = 0
