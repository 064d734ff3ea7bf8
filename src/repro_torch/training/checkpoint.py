"""Checkpoints: a nested dict of tensors <-> ``.npz`` plus a JSON meta file.

The counterpart of src/repro/training/checkpoint.py, in its format: the
leaves are flattened to keys joined by ``__`` (``blocks__attn__wq``), bf16
leaves are stored as ``uint16`` views with a ``"bfloat16"`` tag in
``<path>.meta.json``, beside the step and a free ``meta`` dict.  So a
checkpoint written by either package loads in the other, bit for bit.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, bool]:
    """(array, is bf16): a bf16 tensor as the uint16 view of its bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


def save_checkpoint(path: str, params, step: int = 0, meta: dict | None = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, dtypes = {}, {}
    for k, v in _flatten(params).items():
        a, bf16 = _to_numpy(v)
        if bf16:
            dtypes[k] = "bfloat16"
        arrays[k.replace("/", "__")] = a
    np.savez(path, **arrays)
    with open(path + ".meta.json", "w") as f:
        json.dump({"step": step, "dtypes": dtypes, "meta": meta or {}}, f)


def load_checkpoint(path: str, template=None, device="cuda"):
    """Returns (params, step), every leaf a tensor on ``device``.  With a
    ``template`` (a nested dict/list/tuple, e.g. the model's params) the
    nesting is rebuilt; otherwise a flat {path: tensor} dict is returned."""
    z = np.load(path, allow_pickle=False)
    with open(path + ".meta.json") as f:
        info = json.load(f)
    flat = {}
    for k in z.files:
        key = k.replace("__", "/")
        a = z[k]
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            if info["dtypes"].get(key) == "bfloat16" else torch.from_numpy(a)
        flat[key] = t.to(device)
    if template is None:
        return flat, info["step"]

    def rebuild(tmpl, prefix=""):
        if isinstance(tmpl, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tmpl.items()}
        if isinstance(tmpl, (list, tuple)):
            return type(tmpl)(rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tmpl))
        return flat[prefix[:-1]]

    return rebuild(template), info["step"]
