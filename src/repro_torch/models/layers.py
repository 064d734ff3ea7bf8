"""Shared neural layers: RMSNorm, RoPE, GQA attention, SwiGLU MLP and the
weight initialisers.

The counterpart of src/repro/models/layers.py, with its conventions kept
exactly: ``rms_norm`` computes in fp32 and scales by ``(1 + scale)``;
``rope`` rotates the two halves of the head dim; ``gqa_attend`` takes fp32
logits with the finite ``NEG_INF`` and casts the weights to ``v.dtype``
before the PV product; ``project_qkv`` honours ``qkv_bias``.

The initialisers draw on the target device from an explicit
``torch.Generator`` with the JAX package's distributions and scales; the
values differ from ``jax.random``, so tests bridge JAX weights instead
(repro_torch/bridge.py).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding.  x: (..., T, H, D); positions: (..., T)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    ang = positions[..., None].float() * torch.from_numpy(freqs).to(x.device)  # (..., T, half)
    cos = torch.cos(ang)[..., None, :]  # (..., T, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def init_dense(gen: torch.Generator, din: int, dout: int, dtype: torch.dtype,
               scale: float | None = None) -> torch.Tensor:
    s = scale if scale is not None else 1.0 / np.sqrt(din)
    w = torch.randn((din, dout), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * s).to(dtype)


def attention_weights_init(cfg, gen: torch.Generator) -> dict:
    hd, dt, dev = cfg.hd, cfg.tdtype, gen.device
    p = {
        "wq": init_dense(gen, cfg.d_model, cfg.n_heads * hd, dt),
        "wk": init_dense(gen, cfg.d_model, cfg.n_kv_heads * hd, dt),
        "wv": init_dense(gen, cfg.d_model, cfg.n_kv_heads * hd, dt),
        "wo": init_dense(gen, cfg.n_heads * hd, cfg.d_model, dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dt, device=dev)
    return p


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor | None) -> torch.Tensor:
    """Grouped-query attention core.

    q: (B, T, H, D);  k, v: (B, S, Hkv, D);  mask: broadcastable to
    (B, 1, T, S) boolean (True = attend) or None.
    Returns (B, T, H, D).
    """
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, H // Hkv, D)
    logits = torch.einsum("bthgd,bshd->bhgts", qg, k).float() / np.sqrt(D)
    if mask is not None:
        logits = torch.where(mask[:, :, None] if mask.dim() == 4 else mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", w.to(v.dtype), v)
    return out.reshape(B, T, H, D)


def causal_mask(T: int, window: int = 0, device=None) -> torch.Tensor:
    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    m = j <= i
    if window:
        m = m & (i - j < window)
    return m[None, None]  # (1, 1, T, T)


def swiglu_init(cfg, gen: torch.Generator, d_ff: int | None = None) -> dict:
    f = d_ff or cfg.d_ff
    dt = cfg.tdtype
    return {
        "w_gate": init_dense(gen, cfg.d_model, f, dt),
        "w_up": init_dense(gen, cfg.d_model, f, dt),
        "w_down": init_dense(gen, f, cfg.d_model, dt),
    }


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def project_qkv(p: dict, cfg, x: torch.Tensor):
    hd = cfg.hd
    B, T, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (
        q.reshape(B, T, cfg.n_heads, hd),
        k.reshape(B, T, cfg.n_kv_heads, hd),
        v.reshape(B, T, cfg.n_kv_heads, hd),
    )
