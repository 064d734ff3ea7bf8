"""Wrapper of the Hopper ``commit_kv`` kernel (csrc/commit_kv.cu).

The counterpart of the Pallas TPU kernel ``commit_kv`` in
src/repro/kernels/commit_kv.py: ``k[l, b, dst[b, j]] <- k[l, b, src[b, j]]``
(and v) IN PLACE, every layer, k and v in one launch, with
gather-then-scatter semantics.  ``commit_schedule`` is the launch's rule:
the slice width and the threads of a CTA.  The kernel takes at most
MAX_ENTRIES = 4096 entries (B * P).  The plain PyTorch version is
``kernels.ref.commit_kv_ref``.

This function only launches: it takes CUDA tensors and raises on anything
the kernel does not take (CPU tensors included).  ``kernels.ops`` is the
dispatch by device.  ``commit_kv.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HOLD = 8  # 16-byte vectors a thread holds between its loads and its stores (kHold in the source)
MAX_THREADS = 1024
# B * P: every entry of a slice in one CTA's registers, at two vectors (one 32-byte sector) a slice
MAX_ENTRIES = HOLD * MAX_THREADS // 2
TARGET_UNITS = 512  # (slice, layer, k|v) units of work: about 4 on each of the H100's 132 SMs
THREADS_PER_SM = 2048  # what an SM holds at once
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]


def commit_schedule(L: int, entries: int, fv: int, sms: int) -> tuple[int, int, int]:
    """(slice width, threads, CTAs) of the launch for L layers, ``entries``
    = B * P, ``fv`` 16-byte vectors a lane and a card of ``sms`` SMs.

    The units of work are (slice, layer, k|v), ceil(fv / width) x L x 2 of
    them.  The width is the largest power of two <= 2 L fv / TARGET_UNITS
    (at least 1, at most fv), so there are about TARGET_UNITS units; then
    halved until entries x width <= HOLD x MAX_THREADS.  A CTA takes entries x width
    items of a unit, HOLD a thread, in a multiple of 32 threads; there are
    as many CTAs as units, up to one wave (what the SMs hold at once), and a
    CTA walks the units u, u + CTAs, ..."""
    if not 0 < entries <= MAX_ENTRIES or L <= 0 or fv <= 0:
        raise ValueError(f"commit_kv: {entries} entries over {L} layers of {fv} vectors; the kernel takes 1 to "
                         f"{MAX_ENTRIES} entries")
    width = 1 << max(0, (2 * L * fv // TARGET_UNITS).bit_length() - 1)
    width = min(width, 1 << (fv.bit_length() - 1))
    while entries * width > HOLD * MAX_THREADS:
        width //= 2
    threads = 32 * -(-entries * width // (32 * HOLD))
    units = -(-fv // width) * L * 2
    return width, threads, min(units, sms * (THREADS_PER_SM // threads))


def commit_kv(k: torch.Tensor, v: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    """k, v (L, B, Smax, Hkv, hd); src, dst (B, P) int32 slots.  Moves the
    lanes in place and returns (k, v).  Entries with src == dst or an index
    outside [0, Smax) move nothing, as in the plain version."""
    kernel = "commit_kv"
    build.check_cuda_tensors(kernel, {"k": k, "v": v, "src": src, "dst": dst})
    if k.dim() != 5 or v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError(f"{kernel}: expected k, v (L, B, Smax, Hkv, hd) of one dtype; got "
                         f"{tuple(k.shape)} {k.dtype}, {tuple(v.shape)} {v.dtype}")
    L, B, smax = k.shape[:3]
    lane_bytes = k.shape[3] * k.shape[4] * k.element_size()
    if src.dtype != torch.int32 or dst.dtype != torch.int32 or src.dim() != 2 or dst.shape != src.shape \
            or src.shape[0] != B:
        raise ValueError(f"{kernel}: expected src, dst ({B}, P) int32; got {tuple(src.shape)} {src.dtype}, "
                         f"{tuple(dst.shape)} {dst.dtype}")
    P = src.shape[1]
    if lane_bytes % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{kernel}: lanes of {lane_bytes} bytes; the kernel moves 16-byte vectors "
                         "from 16-byte aligned k and v")
    if B * smax >= 1 << 31:
        raise ValueError(f"{kernel}: {B} rows x {smax} slots; the kernel indexes a layer's lanes in 32 bits")
    sms = torch.cuda.get_device_properties(k.device).multi_processor_count
    width, threads, ctas = commit_schedule(L, B * P, lane_bytes // 16, sms)
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = build.function(kernel, "commit_kv_launch", _ARGTYPES)
        code = fn(k.data_ptr(), v.data_ptr(), src.data_ptr(), dst.data_ptr(), L, B, P, smax,
                  lane_bytes // 16, width, threads, ctas, stream)
    build.check_launch(kernel, code)
    commit_kv.launches += 1
    return k, v


commit_kv.launches = 0
