"""Wrappers of the Hopper split-K flash-decode kernel (csrc/decode_attention_body.cuh,
its bfloat16 instances in csrc/decode_attention.cu, its float32 ones in
csrc/decode_attention_f32.cu).

Counterparts of the Pallas TPU kernels ``decode_attention`` and
``paged_decode_attention`` in src/repro/kernels/decode_attention.py, in the
engine layout: one query token per row, validity from the cache length (and
an optional sliding window), no mask tensor.  The plain PyTorch versions are
``kernels.ref.decode_attention_ref`` and
``kernels.ref.paged_decode_attention_ref``.

These functions only launch: they take CUDA tensors and raise on anything
the kernel does not take (CPU tensors included).  ``kernels.ops`` is the
dispatch by device.  ``decode_attention.launches`` and
``paged_decode_attention.launches`` count the calls of each (one call is
one launch: the last CTA of a row's splits combines them).  ``split_slots``
is the rule that cuts a row's valid range into splits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 48, 64, 128, 256)  # the instances compiled in each dtype's source
_SOURCES = {torch.float32: "decode_attention_f32", torch.bfloat16: "decode_attention"}  # csrc/<name>.cu
HEADS_PER_CTA = 16  # query heads of one KV head a CTA serves: the bf16 kernel's m16 tile (kRows)
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
# the combine's tickets, one int32 per (row, head group), zero between calls: per
# (device, stream), so that calls on two streams never share one; grown, never shrunk
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def split_slots(S: int) -> int:
    """Slots of a row's valid range per CTA: S / 8 rounded up to a power of
    two within [128, 512], so a short cache still spreads over 8 CTAs per
    row and a long one keeps its partial results few (64 splits a row at
    decode_32k's S 32768; the last CTA of a row merges them one after
    another)."""
    return min(512, max(128, 1 << max(0, -(-S // 8) - 1).bit_length()))


def _tickets_for(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least n zeroed int32 tickets for launches on ``stream``.  The kernel
    leaves them at zero, so they are zeroed only when first allocated."""
    key = (device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return t


def _check(kernel: str, q, k, v, lengths, window, tensors: dict) -> None:
    build.check_cuda_tensors(kernel, tensors)
    if q.dtype not in _DTYPES:
        raise ValueError(f"{kernel}: dtype {q.dtype} not supported (bfloat16, float32)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{kernel}: q, k, v dtypes differ ({q.dtype}, {k.dtype}, {v.dtype})")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{kernel}: expected q (B, 1, H, D) and k/v of 4 dims; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape[3] != D or H % Hkv:
        raise ValueError(f"{kernel}: k/v {tuple(k.shape)} do not fit {H} heads of dim {D}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {D} not compiled (have {_HEAD_DIMS})")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise ValueError(f"{kernel}: lengths must be ({B},) int32, got {tuple(lengths.shape)} {lengths.dtype}")
    if int(window) < 0:
        raise ValueError(f"{kernel}: window must be >= 0, got {window}")
    if min(q.numel(), k.numel()) == 0:
        raise ValueError(f"{kernel}: empty problem q {tuple(q.shape)}, k {tuple(k.shape)}")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{kernel}: q, k and v must start on a 16-byte boundary (16-byte loads)")


def _launch(q, k, v, tbl, lengths, S, block, nb, window) -> torch.Tensor:
    B, _, H, D = q.shape
    Hkv = k.shape[2]
    slots = split_slots(S)
    splits = -(-S // slots)
    out = torch.empty_like(q)
    # one fp32 (m, l, acc) partial per (row, head, split), written and read only for the
    # rows whose range takes more than one split
    part_m = torch.empty(B * H * splits, dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(B * H * splits * D, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        tickets = _tickets_for(q.device, stream, B * Hkv * -(-(H // Hkv) // HEADS_PER_CTA))
        source = _SOURCES[q.dtype]
        fn = build.function(source, f"{source}_launch", _ARGTYPES)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None if tbl is None else tbl.data_ptr(),
                  lengths.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
                  tickets.data_ptr(), out.data_ptr(), B, H, Hkv, S, block, nb, D, int(window), slots,
                  _DTYPES[q.dtype], stream)
    build.check_launch(source, code)
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
                     *, window: int = 0) -> torch.Tensor:
    """Flash-decode over a dense cache, on the card.

    q (B, 1, H, D); k, v (B, S, Hkv, D); lengths (B,) int32: slot s of row b
    is valid iff s < lengths[b] (and s >= lengths[b] - window when window >
    0); a row with no valid slot gets the mean of V.  Returns (B, 1, H, D)
    in q's dtype."""
    kernel = "decode_attention"
    _check(kernel, q, k, v, lengths, window, {"q": q, "k": k, "v": v, "lengths": lengths})
    if k.shape[0] != q.shape[0]:
        raise ValueError(f"{kernel}: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    out = _launch(q, k, v, None, lengths, k.shape[1], 0, 0, window)
    decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
                           tbl: torch.Tensor, lengths: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Flash-decode over one layer of a paged arena, on the card.

    q (B, 1, H, D); k_arena, v_arena (NBLK, block, Hkv, D); tbl (B, nb)
    int32, -1 = unmapped (read as the trash block 0); lengths (B,) int32
    over the row's logical slots, validity as in ``decode_attention``.
    Returns (B, 1, H, D) in q's dtype."""
    kernel = "paged_decode_attention"
    _check(kernel, q, k_arena, v_arena, lengths, window,
           {"q": q, "k_arena": k_arena, "v_arena": v_arena, "tbl": tbl, "lengths": lengths})
    if tbl.dtype != torch.int32 or tbl.dim() != 2 or tbl.shape[0] != q.shape[0] or tbl.shape[1] == 0:
        raise ValueError(f"{kernel}: tbl must be ({q.shape[0]}, nb) int32, got {tuple(tbl.shape)} {tbl.dtype}")
    block, nb = k_arena.shape[1], tbl.shape[1]
    out = _launch(q, k_arena, v_arena, tbl, lengths, nb * block, block, nb, window)
    paged_decode_attention.launches += 1
    return out


decode_attention.launches = 0
paged_decode_attention.launches = 0
