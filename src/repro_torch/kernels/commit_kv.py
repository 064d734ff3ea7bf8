"""Wrapper of the Hopper ``commit_kv`` kernel (csrc/commit_kv.cu).

The counterpart of the Pallas TPU kernel ``commit_kv`` in
src/repro/kernels/commit_kv.py: ``k[l, b, dst[b, j]] <- k[l, b, src[b, j]]``
(and v) IN PLACE, every layer, k and v in one launch, with
gather-then-scatter semantics.  The plain PyTorch version is
``kernels.ref.commit_kv_ref``.

This function only launches: it takes CUDA tensors and raises on anything
the kernel does not take (CPU tensors included).  ``kernels.ops`` is the
dispatch by device.  ``commit_kv.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_MAX_ENTRIES = 3072  # B * P: the kernel gathers every entry into 48 KB of shared memory
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                          ctypes.c_void_p]


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
    if not 0 < B * P <= _MAX_ENTRIES or L == 0:
        raise ValueError(f"{kernel}: {B} x {P} entries over {L} layers; the kernel takes 1 to "
                         f"{_MAX_ENTRIES} entries")
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = build.function(kernel, "commit_kv_launch", _ARGTYPES)
        code = fn(k.data_ptr(), v.data_ptr(), src.data_ptr(), dst.data_ptr(), L, B, P, smax,
                  lane_bytes // 16, stream)
    build.check_launch(kernel, code)
    commit_kv.launches += 1
    return k, v


commit_kv.launches = 0
