"""Bridges between the JAX package's pytrees and this package's tensors.

Both sides are given as nested dicts of numpy arrays or tensors with the
same nesting and layer-stacked leaves, so each map is leaf by leaf.  This
module never imports JAX: a caller turns a JAX pytree into numpy first
(``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

import numpy as np
import torch

# norm scales stay fp32 whatever the model dtype, as in the JAX package
_FP32_LEAVES = ("ln1", "ln2", "final_ln")


def params_from_jax(np_params: dict, device="cuda", dtype: torch.dtype = torch.float32) -> dict:
    """The port's parameter dict from a JAX params pytree given as numpy.

    Floating leaves become ``dtype`` (the model's dtype), except the norm
    scales, which stay float32.  bfloat16 numpy arrays (ml_dtypes) are read
    through float32."""

    def conv(name, a):
        if isinstance(a, dict):
            return {k: conv(k, v) for k, v in a.items()}
        arr = np.asarray(a)
        if arr.dtype.kind in "iub":
            return torch.as_tensor(arr, device=device)
        t = torch.as_tensor(np.array(arr, np.float32), device=device)
        return t if name in _FP32_LEAVES else t.to(dtype)

    return {k: conv(k, v) for k, v in np_params.items()}


def cache_to_numpy(cache: dict) -> dict:
    """A cache dict as numpy (floats through float32), for comparing whole
    caches with the JAX package's."""

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return (t.float() if t.is_floating_point() else t).cpu().numpy()

    return conv(cache)
