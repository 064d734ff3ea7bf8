"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427): the
counterpart of src/repro/models/rglru.py.

Real-gated linear recurrent unit:

    r_t = sigmoid(W_a x_t + b_a)                    (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                    (input gate)
    a_t = exp(c * softplus(Lambda) * (-r_t))        (log-space decay, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

preceded by a temporal causal conv (kernel 4, ``ssm._causal_conv``) and
wrapped in the Griffin recurrent-block projections.  Decode carries the
(h, conv tail) state.  The gates, ``lam`` and the state are float32.

torch has no associative scan, so ``_lru_scan`` runs the closed form
h_t = sum_{s <= t} exp(A_t - A_s) b_s (A the cumulative log decay) in
chunks of ``SCAN_CHUNK`` steps, carrying h across chunks.  Only the
differences A_t - A_s (<= 0) are exponentiated, never A alone, which
overflows on long prompts.  Nothing here writes a tensor in place.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_dense
from repro_torch.models.ssm import _causal_conv

_C = 8.0
SCAN_CHUNK = 64  # time steps per chunk of the closed-form scan


def init_rglru(cfg, gen: torch.Generator) -> dict:
    d, dl = cfg.d_model, cfg.lru_d
    nb = cfg.lru_blocks
    if dl % nb:
        raise ValueError(f"lru width {dl} is not a multiple of {nb} gate blocks")
    bd = dl // nb
    dt, dev = cfg.tdtype, gen.device

    def blk():
        return torch.randn((nb, bd, bd), generator=gen, device=dev, dtype=torch.float32) / np.sqrt(bd)

    w_x = init_dense(gen, d, dl, dt)  # input branch
    w_y = init_dense(gen, d, dl, dt)  # gate branch (GeGLU-style)
    conv_w = torch.randn((4, dl), generator=gen, device=dev, dtype=torch.float32)
    return {
        "w_x": w_x,
        "w_y": w_y,
        "conv_w": (conv_w * 0.1).to(dt),
        "conv_b": torch.zeros((dl,), dtype=dt, device=dev),
        # block-diagonal gates (Griffin)
        "w_a": blk(),
        "b_a": torch.zeros((dl,), dtype=torch.float32, device=dev),
        "w_i": blk(),
        "b_i": torch.zeros((dl,), dtype=torch.float32, device=dev),
        "lam": torch.linspace(-4.3, -11.5, dl, dtype=torch.float32, device=dev),  # a in (.9, .999)
        "w_out": init_dense(gen, dl, d, dt),
    }


def _block_gate(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, dl); w (nb, bd, bd) block-diagonal -> (B, S, dl)."""
    B, S, dl = x.shape
    nb, bd, _ = w.shape
    return torch.einsum("bsnd,nde->bsne", x.reshape(B, S, nb, bd), w).reshape(B, S, dl)


def _lru_scan(log_a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None) -> torch.Tensor:
    """h_t = exp(log_a_t) h_{t-1} + b_t over time axis 1, from h0 (or 0).
    log_a, b (B, S, D) float32.  Returns every h_t, (B, S, D)."""
    B, S, D = b.shape
    h = h0
    out = []
    for t0 in range(0, S, SCAN_CHUNK):
        la = log_a[:, t0:t0 + SCAN_CHUNK]
        Q = la.shape[1]
        A = torch.cumsum(la, dim=1)  # (B, Q, D)
        diff = A[:, :, None, :] - A[:, None, :, :]  # (B, t, s, D): A_t - A_s
        causal = torch.ones((Q, Q), dtype=torch.bool, device=b.device).tril()
        w = torch.exp(torch.where(causal[None, :, :, None], diff, float("-inf")))
        hc = torch.einsum("btsd,bsd->btd", w, b[:, t0:t0 + SCAN_CHUNK])
        if h is not None:
            hc = hc + h[:, None, :] * torch.exp(A)
        out.append(hc)
        h = hc[:, -1]
    return torch.cat(out, dim=1)


def rglru_apply(p, cfg, u: torch.Tensor, cache: dict | None):
    """u (B, S, d_model); cache None, or {"state": (B, dl) fp32, "conv":
    (B, 3, dl)}.  Returns (out, {"state", "conv"})."""
    x = u @ p["w_x"]
    gate = F.gelu(u @ p["w_y"], approximate="tanh")
    conv_tail = cache.get("conv") if cache else None
    x, new_tail = _causal_conv(x, p["conv_w"], p["conv_b"], conv_tail)

    xf = x.float()
    r = torch.sigmoid(_block_gate(xf, p["w_a"]) + p["b_a"])
    i = torch.sigmoid(_block_gate(xf, p["w_i"]) + p["b_i"])
    log_a = -_C * F.softplus(p["lam"]) * r  # (B, S, D), negative
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp(1.0 - a2, min=1e-9)) * (i * xf)

    h0 = cache.get("state") if cache else None
    if x.shape[1] == 1 and h0 is not None:
        h = h0 * torch.exp(log_a[:, 0]) + b[:, 0]
        y = h[:, None]
        new_state = h
    else:
        y = _lru_scan(log_a, b, h0)
        new_state = y[:, -1]
    out = (y.to(u.dtype) * gate) @ p["w_out"]
    return out, {"state": new_state, "conv": new_tail}
