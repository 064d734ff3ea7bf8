"""Mamba-2 (SSD, state-space duality) block: the counterpart of
src/repro/models/ssm.py.

The SSD recurrence per head h with state (P, N):

    s_t = exp(dt_t * A) * s_{t-1} + dt_t * B_t x_t^T      (outer product)
    y_t = C_t . s_t  + D * x_t

computed with the chunked dual form (arXiv:2405.21060): within a chunk of Q
tokens a masked quadratic "attention" with decay kernel L = exp(segsum(dtA)),
across chunks a scan over the per-chunk states (a Python loop here, a
``lax.scan`` in JAX).  The terms are those of the JAX package, so float32
results agree to rounding (within 1e-5, tests/test_torch_recurrent.py).

``ssm_apply`` keeps the JAX package's three branches, since which one a pass
takes changes its rounding (and so, in float32, can change a token):

  * S == 1 against a cache: the one-step recurrence;
  * S > 1: pad to ``ssm_chunk``, ``ssd_chunked``, then add the carry-in of
    the cache's state (the speculative trunk, branch and commit passes of
    2-5 tokens take this branch);
  * no cache: ``ssd_chunked`` alone.

The state and ``A_log``, ``D``, ``dt_bias``, ``norm_z`` are float32 whatever
the model dtype.  Nothing here writes a tensor in place: the new state and
conv tail are new tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_dense


def init_ssm(cfg, gen: torch.Generator) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    conv_dim = di + 2 * G * N
    dt, dev = cfg.tdtype, gen.device
    conv_w = torch.randn((cfg.ssm_conv, conv_dim), generator=gen, device=dev, dtype=torch.float32)
    return {
        # fused input projection: [z (di), x (di), B (G*N), C (G*N), dt (H)]
        "w_in": init_dense(gen, d, 2 * di + 2 * G * N + H, dt),
        "conv_w": (conv_w * 0.1).to(dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "w_out": init_dense(gen, di, d, dt),
        "norm_z": torch.zeros((di,), dtype=torch.float32, device=dev),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tail: torch.Tensor | None):
    """Depthwise causal conv along time.  x (B, S, C); w (K, C); tail
    (B, K-1, C) carried state, or None for a pass from the start.  Returns
    (silu(y), new_tail)."""
    K = w.shape[0]
    pad = (torch.zeros((x.shape[0], K - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
           if tail is None else tail.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    return F.silu(y + b), xp[:, -(K - 1):]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., Q) -> (..., Q, Q) lower-triangular segment sums
    segsum[i, j] = sum_{j < m <= i} a[m], -inf above the diagonal."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    lower = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return torch.where(lower, cs[..., :, None] - cs[..., None, :], float("-inf"))


def ssd_chunked(x, dtA, B, C, chunk: int):
    """Chunked SSD scan.

    x (b, S, H, P) head inputs (dt-scaled by the caller); dtA (b, S, H)
    log-decay increments (negative); B, C (b, S, G, N) input and output
    maps.  S must be a multiple of ``chunk``.  Returns y (b, S, H, P) and
    the final state (b, H, P, N).

    The heads are viewed as (G, R), R = H / G heads a group, so the group
    maps broadcast over their heads instead of being repeated (JAX repeats
    them); each product has two operands.  With one chunk (the engines'
    passes of a few tokens) the carry between chunks is zero, so the
    off-diagonal term, exactly zero, is skipped."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if S % chunk:
        raise ValueError(f"sequence of {S} is not padded to the SSD chunk {chunk}")
    c = S // chunk
    R = H // G  # heads per group
    xr = x.reshape(b, c, chunk, G, R, P)
    ar = dtA.reshape(b, c, chunk, G, R)
    Br = B.reshape(b, c, chunk, G, N)
    Cr = C.reshape(b, c, chunk, G, N)

    # intra-chunk (diagonal) term
    L = torch.exp(_segsum(ar.permute(0, 1, 3, 4, 2)))  # (b, c, G, R, Q, Q)
    CB = torch.einsum("bcqgn,bcsgn->bcgqs", Cr, Br)  # (b, c, G, Q, Q)
    y_diag = torch.einsum("bcgrqs,bcsgrp->bcqgrp", CB[:, :, :, None] * L, xr)

    # per-chunk states
    a_cum = torch.cumsum(ar, dim=2)  # (b, c, Q, G, R)
    decay_in = torch.exp(a_cum[:, :, -1:] - a_cum)  # weight of token q into the chunk state
    states = torch.einsum("bcqgn,bcqgrp->bcgrpn", Br, decay_in[..., None] * xr)  # (b, c, G, R, P, N)
    if c == 1:
        return y_diag.reshape(b, S, H, P), states[:, 0].reshape(b, H, P, N)

    # inter-chunk recurrence
    chunk_decay = torch.exp(a_cum[:, :, -1])  # (b, c, G, R)
    s = torch.zeros((b, G, R, P, N), dtype=x.dtype, device=x.device)
    prev = []
    for i in range(c):
        prev.append(s)
        s = s * chunk_decay[:, i, :, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)  # (b, c, G, R, P, N)

    # off-diagonal (carry-in) term
    y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", Cr, prev_states) * torch.exp(a_cum)[..., None]
    y = (y_diag + y_off).reshape(b, S, H, P)
    return y, s.reshape(b, H, P, N)


def ssm_apply(p, cfg, u: torch.Tensor, cache: dict | None):
    """The Mamba-2 mixer.  u (B, S, d_model); cache None, or
    {"state": (B, H, P, N) fp32, "conv": (B, K-1, C)}.  Returns
    (y, {"state", "conv"})."""
    B_, S, _ = u.shape
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim
    G, N = cfg.ssm_groups, cfg.ssm_state
    zxbcdt = u @ p["w_in"]
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    conv_tail = cache.get("conv") if cache else None
    xBC, new_tail = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_tail)
    x, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    x = x.reshape(B_, S, H, P)
    Bm = Bm.reshape(B_, S, G, N)
    Cm = Cm.reshape(B_, S, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, S, H)
    A = -torch.exp(p["A_log"])  # (H,) negative
    dtA = dt * A  # (B, S, H) log-decay
    xdt = x * dt[..., None].to(x.dtype)

    if cache is None or S > 1:
        pad = (-S) % cfg.ssm_chunk
        if pad:
            xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
            dtA_p = F.pad(dtA, (0, 0, 0, pad))
            Bp = F.pad(Bm, (0, 0, 0, 0, 0, pad))
            Cp = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        else:
            dtA_p, Bp, Cp = dtA, Bm, Cm
        init_state = cache.get("state") if cache else None
        y, state = ssd_chunked(xdt.float(), dtA_p, Bp.float(), Cp.float(), cfg.ssm_chunk)
        if init_state is not None:
            # carry-in from an existing state: add C_t exp(cumsum dtA) s_init
            a_cs = torch.cumsum(dtA_p, dim=1)
            carry = torch.einsum("bqgn,bgrpn->bqgrp", Cp.float(), init_state.reshape(B_, G, H // G, P, N))
            y = y + carry.reshape(B_, -1, H, P) * torch.exp(a_cs)[..., None]
            total = torch.exp(dtA_p.sum(dim=1))  # (B, H)
            state = state + init_state * total[:, :, None, None]
        y = y[:, :S]
    else:
        # single-step recurrence
        s = cache["state"]  # (B, H, P, N)
        dec = torch.exp(dtA[:, 0])  # (B, H)
        Brep = Bm.repeat_interleave(H // G, dim=2) if G != H else Bm
        Crep = Cm.repeat_interleave(H // G, dim=2) if G != H else Cm
        s = s * dec[:, :, None, None] + torch.einsum("bhp,bhn->bhpn", xdt[:, 0].float(), Brep[:, 0].float())
        y = torch.einsum("bhn,bhpn->bhp", Crep[:, 0].float(), s)[:, None]
        state = s

    y = y + x.float() * p["D"][:, None]
    y = y.reshape(B_, S, di).to(u.dtype)
    # gated RMSNorm (Mamba-2 style)
    yf = y.float()
    var = yf.square().mean(dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + 1e-6) * (1.0 + p["norm_z"])).to(u.dtype)
    y = y * F.silu(z)
    return y @ p["w_out"], {"state": state, "conv": new_tail}
