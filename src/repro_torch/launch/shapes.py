"""The dry run's input shapes, as fake tensors: the counterpart of
src/repro/launch/shapes.py.

Four shapes, the same table and rules:
    train_4k:     seq 4096,    global batch 256   -> train step
    prefill_32k:  seq 32768,   global batch 32    -> prefill (fills the cache)
    decode_32k:   seq 32768,   global batch 128   -> serve step (1 new token)
    long_500k:    seq 524288,  global batch 1     -> serve step; the SSM and
                  hybrid run natively (O(1) state), the attention families on
                  their sliding-window variant (window 8192 ring cache).

``input_specs(cfg, shape)`` returns (step kind, kwargs, adapted cfg), every
tensor a fake one (``torch._subclasses.fake_tensor.FakeTensorMode``): the
shapes and dtypes of the real inputs with nothing allocated.  ``shape`` is a
name of ``SHAPES`` or a dict of the same fields (``seq``, ``batch``,
``kind``) for a shape of the caller's own.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.models.transformer import init_cache

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def shape_spec(shape) -> tuple[str, dict]:
    """(name, spec) of a name of ``SHAPES`` or of a dict with ``seq``,
    ``batch`` and ``kind`` (named ``{kind}_{seq}x{batch}``)."""
    if isinstance(shape, str):
        return shape, SHAPES[shape]
    if set(shape) != {"seq", "batch", "kind"} or shape["kind"] not in ("train", "prefill", "decode"):
        raise ValueError(f"a shape is a name of SHAPES or a dict of seq, batch and kind; got {shape!r}")
    return f"{shape['kind']}_{shape['seq']}x{shape['batch']}", dict(shape)


def adapt_config(cfg, shape):
    """Shape-driven config adaptation (the long-context attention variant)."""
    name, _ = shape_spec(shape)
    if name == "long_500k" and cfg.arch_type in ("dense", "moe", "vlm", "encdec"):
        cfg = cfg.replace(attention="sliding_window", window=8192)
    return cfg


def cache_smax(cfg, shape) -> int:
    if cfg.arch_type == "hybrid":
        return cfg.local_window
    if cfg.attention == "sliding_window":
        return cfg.window
    return shape_spec(shape)[1]["seq"]


def input_specs(cfg, shape, fake_mode: FakeTensorMode | None = None):
    """Returns (kind, kwargs of fake tensors, adapted cfg).  The tensors
    belong to ``fake_mode`` (a new one when None): a caller that also builds
    fake parameters passes its own, since fake tensors of two modes do not
    mix."""
    _, spec = shape_spec(shape)
    cfg = adapt_config(cfg, shape)
    B, S, kind = spec["batch"], spec["seq"], spec["kind"]
    dt = cfg.tdtype
    with fake_mode or FakeTensorMode():
        toks = S
        kw = {}
        if kind != "decode":
            if cfg.arch_type == "vlm":
                toks = S - cfg.n_patches
                kw["embeds"] = torch.empty((B, cfg.n_patches, cfg.d_model), dtype=dt)
            if cfg.arch_type == "encdec":
                kw["enc_embeds"] = torch.empty((B, cfg.enc_len, cfg.d_model), dtype=dt)
        if kind == "train":
            batch = {"tokens": torch.empty((B, toks), dtype=torch.int32),
                     "labels": torch.empty((B, toks), dtype=torch.int32), **kw}
            return kind, {"batch": batch}, cfg
        cache = init_cache(cfg, B, cache_smax(cfg, shape), "cpu")
        if kind == "prefill":
            return kind, {"cache": cache, "tokens": torch.empty((B, toks), dtype=torch.int32), **kw}, cfg
        return kind, {"cache": cache, "tokens": torch.empty((B, 1), dtype=torch.int32)}, cfg
