"""The dense GQA decoder stack: ``init_params``, ``forward``, ``init_cache``.

The counterpart of the dense branches of src/repro/models/transformer.py.
Parameters are plain dicts of tensors with the JAX nesting, layer-stacked on
a leading L axis (``params["blocks"]["attn"]["wq"]`` is (L, d, H*hd)), so the
bridge maps one to one.  Each ``lax.scan`` over layers is a Python loop over
layer views.

Every masked attention pass goes through ``kernels.ops.gqa_tree_attention``,
as the JAX ``attention_impl="pallas"`` path does: a pass whose tensors lie
on the CPU takes the plain version, one on the card launches the Hopper
kernel, once per layer.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import gqa_tree_attention
from repro_torch.models.cache import (
    append_layer_kv,
    attn_mask_from_pos,
    cache_slots,
    init_attn_cache,
    tree_mask_from_pos,
)
from repro_torch.models.layers import (
    attention_weights_init,
    causal_mask,
    init_dense,
    project_qkv,
    rms_norm,
    rope,
    swiglu,
    swiglu_init,
)


def _require_dense(cfg):
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r}: this package runs the dense family so far "
            "(ROADMAP queue 1 items 7, 9 and 10 port the others)")


# ----------------------------------------------------------------- params ----


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _stack_init(fn, n: int) -> dict:
    """Layer-stack n draws of ``fn()`` into (n, ...) tensors, one layer at a
    time, so the peak is the stack plus one layer (not twice the stack)."""
    first = fn()
    out = _map(lambda t: t.new_empty((n,) + t.shape), first)

    def put(dst, src, i):
        for key, val in src.items():
            if isinstance(val, dict):
                put(dst[key], val, i)
            else:
                dst[key][i] = val

    put(out, first, 0)
    for i in range(1, n):
        put(out, fn(), i)
    return out


def _attn_mlp_layer_init(cfg, gen: torch.Generator) -> dict:
    dev = gen.device
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
        "attn": attention_weights_init(cfg, gen),
        "ln2": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
        "mlp": swiglu_init(cfg, gen),
    }


def init_params(cfg, gen: torch.Generator) -> dict:
    """Random weights drawn on ``gen.device``: normal x 0.02 for ``embed``,
    normal x 1/sqrt(d_in) for dense layers, zero norm scales (fp32)."""
    _require_dense(cfg)
    dt, dev = cfg.tdtype, gen.device
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=gen, device=dev, dtype=torch.float32)
    params = {
        "embed": (embed * 0.02).to(dt),
        "final_ln": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
    }
    del embed
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(gen, cfg.d_model, cfg.vocab, dt)
    params["blocks"] = _stack_init(lambda: _attn_mlp_layer_init(cfg, gen), cfg.n_layers)
    return params


# ----------------------------------------------------------------- blocks ----


def _self_attention(p, cfg, x, positions, mask, layer_cache):
    """layer_cache: None or (k, v, slots) views of one layer of the ring."""
    B, T, _ = x.shape
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = project_qkv(p["attn"], cfg, h)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if layer_cache is not None:
        kc, vc, slots = layer_cache
        k, v = append_layer_kv(kc, vc, k, v, slots)
    att = gqa_tree_attention(q, k, v, mask[:, 0])
    return x + att.reshape(B, T, -1) @ p["attn"]["wo"]


def _attn_mlp_block(p, cfg, x, positions, mask, layer_cache):
    x = _self_attention(p, cfg, x, positions, mask, layer_cache)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu(p["mlp"], h)


# ---------------------------------------------------------------- forward ----


def _mk_masks(cfg, mode, T, pos, positions, anc, slots):
    """The full-attention mask of a pass, (1 or Ba, 1, T, S).

    ``pos`` is the slot->absolute-position table *after* writing the new
    tokens, so queries can see themselves and each other causally.  (The
    JAX version also returns the local-window mask of the hybrid family.)
    """
    win = cfg.window if cfg.attention == "sliding_window" else 0
    if mode == "full":
        return causal_mask(T, win, device=positions.device)
    if mode == "decode":
        return attn_mask_from_pos(pos, positions, win)
    return tree_mask_from_pos(pos, positions, anc, slots, win)


def _tree_depths(anc: torch.Tensor) -> torch.Tensor:
    """Position offsets of tree tokens = (ancestor count - 1).  A (Ba, T, T)
    anc shares one topology in the lockstep cache (depths from row 0)."""
    a = anc if anc.dim() == 2 else anc[0]
    return a.to(torch.int32).sum(dim=-1, dtype=torch.int32) - 1


def forward(params: dict, cfg, tokens: torch.Tensor, *, mode: str = "full",
            cache: dict | None = None, anc: torch.Tensor | None = None):
    """Returns (logits fp32 (B, T, V), new_cache, {"hidden": (B, T, d)}).

    mode "full":   causal pass over tokens; if ``cache`` is given it is
                   filled (prefill), else no cache is built.
    mode "decode": T new tokens against the cache.
    mode "tree":   T speculation-tree tokens with ancestor mask ``anc``
                   ((T, T) or (Ba, T, T) bool).
    The new K/V are written into ``cache``'s k/v in place (models/cache.py);
    ``new_cache`` shares them and carries new pos/len tensors.
    """
    _require_dense(cfg)
    dt = cfg.tdtype
    x = params["embed"][tokens].to(dt)
    B, T, _ = x.shape
    dev = x.device

    length = cache["attn"]["len"] if cache is not None else torch.zeros((), dtype=torch.int32, device=dev)
    offs = torch.arange(T, dtype=torch.int32, device=dev) if anc is None else _tree_depths(anc)
    positions = length + offs

    new_cache = None
    slots = None
    if cache is not None:
        if mode == "full":
            mode = "decode"  # prefill == appending T tokens causally to an empty cache
        a = cache["attn"]
        slots = cache_slots(length, T, a["pos"].shape[0])
        new_pos = a["pos"].clone()
        new_pos[slots.long()] = positions
        mask = _mk_masks(cfg, mode, T, new_pos, positions, anc, slots)
        new_cache = dict(cache)
        new_cache["attn"] = {"k": a["k"], "v": a["v"], "pos": new_pos, "len": length + T}
    else:
        mask = _mk_masks(cfg, "full", T, None, positions, None, None)

    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        pl = _map(lambda t: t[i], blocks)
        layer_cache = None if cache is None else (cache["attn"]["k"][i], cache["attn"]["v"][i], slots)
        x = _attn_mlp_block(pl, cfg, x, positions, mask, layer_cache)

    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head).float()
    return logits, new_cache, {"hidden": x}


# ------------------------------------------------------------------ cache ----


def init_cache(cfg, batch: int, smax: int, device) -> dict:
    """Empty lockstep decode cache (models/cache.py layout)."""
    _require_dense(cfg)
    return {"attn": init_attn_cache(cfg, cfg.n_layers, batch, smax, cfg.tdtype, device)}
