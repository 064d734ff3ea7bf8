"""Engine-facing kernel entry points, dispatched by the tensors' device.

The counterpart of src/repro/kernels/ops.py.  A CPU tensor takes the plain
version (kernels/ref.py); a CUDA tensor launches the hand-written kernel,
which raises on anything it does not take.  There is no other fallback.

Unlike the TPU wrappers, these pad nothing (T to 8, S to a block multiple
are TPU tiling rules) and replicate nothing (the kernel reads KV head
h // (H / Hkv) and broadcasts a (1, T, S) mask by indexing).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import tree_attention_ref
from repro_torch.kernels.tree_attention import tree_attention


def gqa_tree_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """q (B, T, H, D); k, v (B, S, Hkv, D); mask (B, T, S) or (1, T, S) bool.
    Returns (B, T, H, D)."""
    if q.device.type == "cpu":
        return tree_attention_ref(q, k, v, mask)
    return tree_attention(q, k, v, mask)
