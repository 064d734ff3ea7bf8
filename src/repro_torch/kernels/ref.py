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
