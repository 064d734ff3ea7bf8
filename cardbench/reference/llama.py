"""The llama family (dense): its weights drawn from the seed, its active
parameter count, and its plain reference.

Weights (``draw_pair``), in the layout of the port's parameter dicts
(``embed``, ``final_ln``, ``lm_head``, layer-stacked ``blocks`` of {ln1,
attn {wq, wk, wv, wo}, ln2, mlp {w_gate, w_up, w_down}}), a leaf at a time
in the type served, by one ``torch.Generator`` on the device: normal x
1/sqrt(d_in) for every projection, normal x 0.1 for the norm scales (the
port scales by 1 + scale, so non-zero scales exercise it; float32, as the
port keeps them).  The output projections (``wo``, ``w_down``) are damped
by the configuration's ``weights.block_out_scale``, and the draft is tied
to the target so that it guesses the target's choice as a trained draft
does: a draft embedding Z (normal, unit scale), a fixed projection P (the
orthonormal columns of a normal (d_target, d_draft) matrix), the target's
embedding Z P^T and the draft's head diag(1 / (1 + s_draft)) P^T
diag(1 + s_target) W_target, s being the final norms' scales.  With the
blocks damped both models then put first the same token up to what their
own blocks add; the damping sets how often.

The reference (``logits``): float32 throughout, TF32 off, one sequence at a
time, no cache, no kernel: embedding lookup; per layer RMSNorm scaled by
(1 + scale), the Q/K/V projections, rotary embedding over the two halves of
each head, causal grouped-query attention, the output projection and the
residual; RMSNorm, a SwiGLU MLP and the residual; the final RMSNorm and the
lm head.  These are the equations of
src/repro_torch/models/{layers,transformer}.py, written again from the
published architecture; nothing here imports the port or the JAX package.

``precision="fp8"`` is the control: every linear layer (projections, lm
head) takes its weight quantised to float8 e4m3 per output column and its
input per row, then multiplies in float32; the norms and the attention
products stay float32.  It stands for the step below the configuration's
bfloat16 that a later change might take.
"""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


# ------------------------------------------------------------------ weights --

def _normal(gen, shape, dtype, scale):
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype).mul_(scale)


def _stack(gen, n, shape, dtype, scale):
    """(n, *shape), one draw a layer."""
    out = torch.empty((n, *shape), dtype=dtype, device=gen.device)
    for i in range(n):
        out[i] = _normal(gen, shape, dtype, scale)
    return out


def _blocks(cfg, gen, out_scale: float) -> dict:
    dt, L, d, hd, f = cfg.tdtype, cfg.n_layers, cfg.d_model, cfg.hd, cfg.d_ff
    f32 = torch.float32
    proj = lambda din, dout, s=1.0: _stack(gen, L, (din, dout), dt, s / math.sqrt(din))
    return {
        "ln1": _normal(gen, (L, d), f32, 0.1),
        "attn": {"wq": proj(d, cfg.n_heads * hd), "wk": proj(d, cfg.n_kv_heads * hd),
                 "wv": proj(d, cfg.n_kv_heads * hd), "wo": proj(cfg.n_heads * hd, d, out_scale)},
        "ln2": _normal(gen, (L, d), f32, 0.1),
        "mlp": {"w_gate": proj(d, f), "w_up": proj(d, f), "w_down": proj(f, d, out_scale)},
    }


def draw_pair(tcfg, dcfg, gen: torch.Generator, spec: dict) -> tuple[dict, dict]:
    """(target, draft) parameter dicts; ``spec`` is the configuration file's
    ``weights`` entry."""
    for cfg in (tcfg, dcfg):
        if cfg.arch_type != "dense" or cfg.qkv_bias or cfg.tie_embeddings:
            raise ValueError(f"no llama weights for {cfg.arch_type!r} with these options")
    if dcfg.vocab != tcfg.vocab or dcfg.d_model > tcfg.d_model:
        raise ValueError("the draft shares the target's vocabulary and is no wider")
    dt, f32 = tcfg.tdtype, torch.float32
    out_scale = float(spec["block_out_scale"])
    z = _normal(gen, (tcfg.vocab, dcfg.d_model), f32, 1.0)
    p, _ = torch.linalg.qr(_normal(gen, (tcfg.d_model, dcfg.d_model), f32, 1.0))
    s_t, s_d = _normal(gen, (tcfg.d_model,), f32, 0.1), _normal(gen, (dcfg.d_model,), f32, 0.1)
    w_t = _normal(gen, (tcfg.d_model, tcfg.vocab), dt, 1 / math.sqrt(tcfg.d_model))
    w_d = ((p.T * (1 + s_t)) @ w_t.float()) / (1 + s_d)[:, None]
    target = {"embed": (z @ p.T).to(dt), "final_ln": s_t, "lm_head": w_t,
              "blocks": _blocks(tcfg, gen, out_scale)}
    draft = {"embed": z.to(dcfg.tdtype), "final_ln": s_d, "lm_head": w_d.to(dcfg.tdtype),
             "blocks": _blocks(dcfg, gen, out_scale)}
    return target, draft


def active_params(cfg) -> int:
    """Parameters a token passes through, the embedding lookup left out and
    the lm head counted."""
    d, hd = cfg.d_model, cfg.hd
    attn = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
    return cfg.n_layers * (attn + 3 * d * cfg.d_ff) + d * cfg.vocab


# ---------------------------------------------------------------- reference --

def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float() * scale


def _linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    w = w.float()
    if precision == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * (1.0 + scale.float())


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, D) at positions 0 .. T-1."""
    T, _, D = x.shape
    half = D // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half))
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, block: int = 512):
    """Causal GQA: q (T, H, D), k and v (T, Hkv, D), in query blocks."""
    T, H, D = q.shape
    G = H // k.shape[1]
    kk = k.repeat_interleave(G, dim=1).transpose(0, 1)  # (H, T, D)
    vv = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for s in range(0, T, block):
        e = min(T, s + block)
        logits = torch.einsum("thd,hsd->hts", q[s:e], kk[:, :e]) / math.sqrt(D)
        keep = torch.arange(e, device=q.device)[None, :] <= torch.arange(s, e, device=q.device)[:, None]
        logits = logits.masked_fill(~keep, float("-inf"))
        out[s:e] = torch.einsum("hts,hsd->thd", torch.softmax(logits, dim=-1), vv[:, :e])
    return out


def _swiglu(h, w_gate, w_up, w_down, precision):
    g = torch.nn.functional.silu(_linear(h, w_gate, precision))
    return _linear(g * _linear(h, w_up, precision), w_down, precision)


def logits(params: dict, cfg: dict, tokens: torch.Tensor, precision: str = "fp32",
           vocab_block: int = 16384) -> torch.Tensor:
    """Float32 logits (T, V) of one sequence ``tokens`` (T,) at positions
    0 .. T-1.  ``cfg``: the configuration's fields (n_layers, n_heads,
    n_kv_heads, head_dim, rope_theta, norm_eps)."""
    if precision not in ("fp32", "fp8"):
        raise ValueError(precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    H, Hkv, D, eps = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["norm_eps"]
    T = tokens.shape[0]
    x = params["embed"][tokens].float()
    b = params["blocks"]
    for i in range(cfg["n_layers"]):
        a = b["attn"]
        h = _rms(x, b["ln1"][i], eps)
        q = _linear(h, a["wq"][i], precision).view(T, H, D)
        k = _linear(h, a["wk"][i], precision).view(T, Hkv, D)
        v = _linear(h, a["wv"][i], precision).view(T, Hkv, D)
        att = _attention(_rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"]), v)
        x = x + _linear(att.reshape(T, H * D), a["wo"][i], precision)
        h = _rms(x, b["ln2"][i], eps)
        m = b["mlp"]
        x = x + _swiglu(h, m["w_gate"][i], m["w_up"][i], m["w_down"][i], precision)
    h = _rms(x, params["final_ln"], eps)
    head = params["lm_head"]
    return torch.cat([_linear(h, head[:, s:s + vocab_block], precision)
                      for s in range(0, head.shape[1], vocab_block)], dim=1)
