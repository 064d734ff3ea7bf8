"""Bridges between the JAX package's pytrees and this package's tensors.

Both sides are given as nested dicts of numpy arrays or tensors with the
same nesting and layer-stacked leaves, so each map is leaf by leaf.  This
module never imports JAX: a caller turns a JAX pytree into numpy first
(``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

import numpy as np
import torch

# norm scales (the cross-attention's ln_x and the encoder's enc_ln too), the
# MoE router, and the SSM's and RG-LRU's gates, decays and norms stay fp32
# whatever the model dtype, as in the JAX package (a rounded router would
# change routing; a rounded decay would change the state)
_FP32_LEAVES = ("ln1", "ln2", "final_ln", "router", "ln_x", "enc_ln",
                "ln", "ln_m", "A_log", "D", "dt_bias", "norm_z",  # models/ssm.py, the hybrid's rec layers
                "w_a", "b_a", "w_i", "b_i", "lam")  # models/rglru.py


def params_from_jax(np_params: dict, device="cuda", dtype: torch.dtype = torch.float32) -> dict:
    """The port's parameter dict from a JAX params pytree given as numpy.

    Floating leaves become ``dtype`` (the model's dtype), except those the
    JAX package keeps float32 (``_FP32_LEAVES``).  bfloat16 numpy arrays
    (ml_dtypes) are read through float32."""

    def conv(name, a):
        if isinstance(a, dict):
            return {k: conv(k, v) for k, v in a.items()}
        arr = np.asarray(a)
        if arr.dtype.kind in "iub":
            return torch.as_tensor(arr, device=device)
        t = torch.as_tensor(np.array(arr, np.float32), device=device)
        return t if name in _FP32_LEAVES else t.to(dtype)

    return {k: conv(k, v) for k, v in np_params.items()}


def selector_params_from_jax(np_params: dict, device="cuda") -> dict:
    """The port's selector parameters (core/selector.py) from the JAX
    package's, given as numpy.  Both keep the dense layers as
    ``{"w": (din, dout), "b": (dout,)}`` (``x @ w + b``; an ``nn.Linear``
    weight would be the transpose), so each leaf is copied as float32."""
    return {name: {k: torch.as_tensor(np.array(a, np.float32), device=device) for k, a in layer.items()}
            for name, layer in np_params.items()}


def cache_to_numpy(cache: dict) -> dict:
    """A cache dict as numpy (floats through float32), for comparing whole
    caches with the JAX package's."""

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return (t.float() if t.is_floating_point() else t).cpu().numpy()

    return conv(cache)
