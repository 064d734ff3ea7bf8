"""Wrapper of the Hopper ``tree_attention`` kernel (csrc/tree_attention.cu).

The counterpart of the Pallas TPU kernel ``tree_attention`` in
src/repro/kernels/tree_attention.py, in the engine layout: q (B, T, H, D),
k/v (B, S, Hkv, D), mask (Bm, T, S) bool with Bm in {1, B}.  GQA and the
mask broadcast are done by indexing inside the kernel.  The plain PyTorch
version of the same function is ``kernels.ref.tree_attention_ref``.

This function only launches: it takes CUDA tensors and raises on anything
the kernel does not take (CPU tensors included).  ``kernels.ops`` is the
dispatch by device.  ``tree_attention.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)  # the instances compiled in csrc/tree_attention.cu
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = build.function("tree_attention", "tree_attention_launch", _ARGTYPES)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                  B, T, H, Hkv, S, D, mask.shape[0], _DTYPES[q.dtype], stream)
    build.check_launch("tree_attention", code)
    tree_attention.launches += 1
    return out


tree_attention.launches = 0
