"""The model stacks of every family: ``init_params``, ``forward``,
``init_cache``, and training's ``loss_fn``, ``loss_and_grads`` and
``make_train_step``.

The counterpart of src/repro/models/transformer.py (its dense, VLM, MoE,
SSM, hybrid and encoder-decoder branches).  Parameters are plain dicts of
tensors with the JAX nesting, layer-stacked on a leading axis
(``params["blocks"]["attn"]["wq"]`` is (L, d, H*hd)), so the bridge maps one
to one.  An interleaved MoE stack (``moe_every`` = m > 1, Llama-4 style)
nests ``blocks.dense{i}`` (i < m - 1) and ``blocks.moe``, each stacked over
the n_layers // m groups; layer i of group g is cache layer g*m + i.  The
SSM stack (Mamba-2) is ``blocks.{ln, ssm}``; the hybrid (RecurrentGemma)
stacks (rec, rec, local-attn) groups as ``blocks.{rec0, rec1, attn}`` and
the n_layers % 3 recurrent layers past the last group as ``tail``.  The
VLM stack is the dense one plus ``patch_proj`` (d, d), which projects the
patch embeddings a prefill prepends.  The encoder-decoder (Whisper
backbone) adds ``enc_blocks`` (n_enc_layers dense layers) and ``enc_ln``,
and each decoder layer a cross-attention (``ln_x``, ``xattn``) over the
encoder's output, whose per-layer K/V a prefill caches as ``cross_k`` /
``cross_v``.  Each ``lax.scan`` over layers is a Python loop over layer
views.

Every masked attention pass goes through ``kernels.ops``, as the JAX
``attention_impl="pallas"`` path does: ``gqa_tree_attention`` over a ring
cache (or none), ``gqa_paged_tree_attention`` over a paged pool and
``gqa_ragged_tree_attention`` for the ragged tree pass.  The hybrid's
local-attention layers take the same kernels under the local-window mask.
A pass whose tensors lie on the CPU takes the plain versions, one on the
card launches the Hopper kernels, once per attention layer.  The unmasked
attention of the Whisper encoder and every cross-attention take the plain
``gqa_attend``, as in JAX, whose ``mask is not None`` test sends them to
XLA under ``attention_impl="pallas"`` too: they reach no TPU kernel.

Training (``forward(..., train=True)``, set by ``loss_fn``) takes the plain,
differentiable ``gqa_attend`` under the causal or local-window mask on every
device, so it reaches no hand-written kernel (they have no backward, and
``kernels.ops`` refuses a tensor that requires grad).  This is the JAX
package's training path: it trains through its default
``attention_impl="xla"`` (src/repro/models/config.py:39), and under
``"pallas"`` ``jax.value_and_grad(loss_fn)`` raises an ``AssertionError``
from the ``pallas_call``, whose kernels define no VJP.  ``train=True`` also
turns on the MoE capacity-factor dispatch (models/moe.py) and, with
``cfg.remat``, recomputes each layer's activations in the backward pass
(``torch.utils.checkpoint``), as JAX's ``jax.checkpoint`` of each scan body.
"""
from __future__ import annotations

from functools import partial

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ops import gqa_paged_tree_attention, gqa_ragged_tree_attention, gqa_tree_attention
from repro_torch.models.act_sharding import (pin, replicated, ring_attention, rows, rows_gathered, split_heads,
                                             tensor_parallel)
from repro_torch.models.cache import (
    append_layer_kv,
    attn_mask_from_pos,
    cache_slots,
    init_attn_cache,
    init_paged_attn_cache,
    paged_append_layer_kv,
    paged_phys_slots,
    ragged_tree_mask,
    tree_mask_from_pos,
)
from repro_torch.models.layers import (
    attention_weights_init,
    causal_mask,
    gqa_attend,
    init_dense,
    project_qkv,
    rms_norm,
    rope,
    swiglu,
    swiglu_init,
)
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.rglru import init_rglru, rglru_apply
from repro_torch.models.ssm import init_ssm, ssm_apply

RECURRENT = ("ssm", "hybrid")
# the families whose every layer is attention + MLP (the dense-like stacks)
ATTN_STACKS = ("dense", "vlm", "moe", "encdec")
ARCH_TYPES = ATTN_STACKS + RECURRENT


def _check_arch(cfg):
    if cfg.arch_type not in ARCH_TYPES:
        raise ValueError(cfg.arch_type)


# ----------------------------------------------------------------- params ----


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _leaves(tree) -> list:
    return [x for v in tree.values() for x in (_leaves(v) if isinstance(v, dict) else [v])]


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


def _attn_mlp_layer_init(cfg, gen: torch.Generator, moe: bool = False, d_ff: int | None = None,
                         cross: bool = False) -> dict:
    dev = gen.device
    p = {
        "ln1": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
        "attn": attention_weights_init(cfg, gen),
        "ln2": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
        "mlp": init_moe(cfg, gen) if moe else swiglu_init(cfg, gen, d_ff=d_ff),
    }
    if cross:
        p["ln_x"] = torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev)
        p["xattn"] = attention_weights_init(cfg, gen)
    return p


def _rec_layer_init(cfg, gen: torch.Generator) -> dict:
    dev = gen.device
    return {
        "ln": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
        "rec": init_rglru(cfg, gen),
        "ln_m": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
        "mlp": swiglu_init(cfg, gen),
    }


def init_params(cfg, gen: torch.Generator) -> dict:
    """Random weights drawn on ``gen.device``: normal x 0.02 for ``embed``,
    normal x 1/sqrt(d_in) for dense layers and experts, zero norm scales,
    the MoE router and the SSM and RG-LRU gates, decays and norms in fp32
    (models/ssm.py, models/rglru.py).  An unknown ``arch_type`` raises
    ``ValueError``, as in JAX."""
    _check_arch(cfg)
    dt, dev = cfg.tdtype, gen.device
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=gen, device=dev, dtype=torch.float32)
    params = {
        "embed": (embed * 0.02).to(dt),
        "final_ln": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
    }
    del embed
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(gen, cfg.d_model, cfg.vocab, dt)
    if cfg.arch_type == "moe" and cfg.moe_every > 1:
        m = cfg.moe_every
        if cfg.n_layers % m:
            raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of moe_every {m}")
        dense_ff = cfg.moe_dense_ff or cfg.d_ff

        def macro_init():
            gp = {f"dense{i}": _attn_mlp_layer_init(cfg, gen, d_ff=dense_ff) for i in range(m - 1)}
            gp["moe"] = _attn_mlp_layer_init(cfg, gen, moe=True)
            return gp

        params["blocks"] = _stack_init(macro_init, cfg.n_layers // m)
    elif cfg.arch_type == "ssm":
        params["blocks"] = _stack_init(
            lambda: {"ln": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev), "ssm": init_ssm(cfg, gen)},
            cfg.n_layers)
    elif cfg.arch_type == "hybrid":
        g = cfg.hybrid_attn_every
        n_groups, rem = divmod(cfg.n_layers, g)

        def group_init():
            gp = {f"rec{i}": _rec_layer_init(cfg, gen) for i in range(g - 1)}
            gp["attn"] = _attn_mlp_layer_init(cfg, gen)
            return gp

        params["blocks"] = _stack_init(group_init, n_groups)
        if rem:
            params["tail"] = _stack_init(lambda: _rec_layer_init(cfg, gen), rem)
    elif cfg.arch_type == "encdec":
        params["enc_blocks"] = _stack_init(lambda: _attn_mlp_layer_init(cfg, gen), cfg.n_enc_layers)
        params["enc_ln"] = torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev)
        params["blocks"] = _stack_init(lambda: _attn_mlp_layer_init(cfg, gen, cross=True), cfg.n_layers)
    else:  # dense, vlm, flat moe
        moe = cfg.arch_type == "moe"
        params["blocks"] = _stack_init(lambda: _attn_mlp_layer_init(cfg, gen, moe=moe), cfg.n_layers)
        if cfg.arch_type == "vlm":
            params["patch_proj"] = init_dense(gen, cfg.d_model, cfg.d_model, dt)
    return params


def _unstack(tree: dict) -> list[dict]:
    """The layer views of a layer-stacked tree, by one ``unbind`` a leaf.
    In a training pass the backward of ``unbind`` stacks every layer's
    gradient in one op; taking a layer at a time (``t[i]``) would add a
    stack-sized gradient for each layer, traffic quadratic in depth."""
    parts = {k: _unstack(v) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def _layers(params: dict, cfg):
    """(layer params, is_moe) in cache-layer order (the ATTN_STACKS)."""
    blocks = params["blocks"]
    if cfg.arch_type == "moe" and cfg.moe_every > 1:
        m = cfg.moe_every
        dense = [_unstack(blocks[f"dense{i}"]) for i in range(m - 1)]
        for g, moe_layer in enumerate(_unstack(blocks["moe"])):
            for i in range(m - 1):
                yield dense[i][g], False
            yield moe_layer, True
    else:
        moe = cfg.arch_type == "moe"
        for layer in _unstack(blocks):
            yield layer, moe


# ----------------------------------------------------------------- blocks ----


def _self_attention(p, cfg, x, positions, mask, layer_cache, ragged=None, train=False):
    """layer_cache: None or (k, v, slots, page) views of one layer, with
    page = None (ring cache) or the (B, max_blocks) block table of a paged
    pool.  ragged: None, or the (N,) owner row of each node of the ragged
    tree pass (-1 = padding lane); then x is (1, N, d), ``slots`` are
    per-node ring slots in the owner's row (Smax = padding lane) and
    ``mask`` is (N, Smax).  mask None (the Whisper encoder: no cache)
    attends every key through the plain ``gqa_attend``, as JAX does, and so
    does a training pass (``train``, no cache) under its causal mask."""
    B, T, _ = x.shape
    h = rows(rms_norm(x, p["ln1"], cfg.norm_eps))
    if isinstance(h, DTensor) and (mask is None or train):
        return x + _tensor_parallel_attention(p["attn"], cfg, h, positions, mask)
    q, k, v = project_qkv(p["attn"], cfg, h)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if mask is None or train:
        return x + gqa_attend(q, k, v, mask).reshape(B, T, -1) @ p["attn"]["wo"]
    if ragged is not None:
        kc, vc, slots, page_tbl = layer_cache
        # each node into its owner's mapped lane; padding lanes (slot
        # sentinel) and unmapped blocks into the trash block, where JAX drops
        # the write
        block = kc.shape[1]
        smax = page_tbl.shape[1] * block
        sl = torch.where(slots < smax, slots, 0)
        lanes = paged_phys_slots(page_tbl[ragged.long().clamp_min(0)], sl[:, None], block)[:, 0]
        lanes = torch.where(slots < smax, lanes, 0).long()
        kf = kc.view((-1,) + kc.shape[2:])
        vf = vc.view((-1,) + vc.shape[2:])
        kf.index_copy_(0, lanes, k[0].to(kf.dtype))
        vf.index_copy_(0, lanes, v[0].to(vf.dtype))
        att = gqa_ragged_tree_attention(q[0], kc, vc, page_tbl, ragged, mask)
        return x + att.reshape(1, T, -1) @ p["attn"]["wo"]
    m3 = mask[:, 0]
    if layer_cache is None:
        att = gqa_tree_attention(q, k, v, m3)
    else:
        kc, vc, slots, page_tbl = layer_cache
        if page_tbl is None and isinstance(q, DTensor):  # the dry run over a mesh: each rank its rows
            att = ring_attention(lambda q, k, v, m: gqa_tree_attention(q, k, v, m[:, 0]), append_layer_kv,
                                 q, k, v, kc, vc, slots, mask)
        elif page_tbl is None:
            kc, vc = append_layer_kv(kc, vc, k, v, slots)
            att = gqa_tree_attention(q, kc, vc, m3)
        else:
            paged_append_layer_kv(kc, vc, k, v, slots, page_tbl)
            att = gqa_paged_tree_attention(q, kc, vc, page_tbl, m3)
    return x + att.reshape(B, T, -1) @ p["attn"]["wo"]


def _tensor_parallel_attention(pa, cfg, h, positions, mask):
    """A pass without a cache (training, the encoder) on DTensors: the
    query heads column-parallel over ``"model"`` where they divide, and the
    kv heads too where they divide (else each rank projects them whole and
    keeps the kv head of each of its query heads), ``wo`` row-parallel
    (act_sharding.tensor_parallel).  Returns the attention's output,
    before the residual."""
    mesh = h.device_mesh
    m = mesh.size(mesh.mesh_dim_names.index("model"))
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    split = m > 1 and H % m == 0
    kv_split = split and Hkv % m == 0
    bias = lambda *names: [pa[n] for n in names] if cfg.qkv_bias else []
    qw, kvw = [pa["wq"]] + bias("bq"), [pa["wk"], pa["wv"]] + bias("bk", "bv")

    def attend(hl, *ws):
        *ws, rank = ws
        if kv_split:
            q_w, kv_w, wo = ws[:len(qw)], ws[len(qw):len(qw) + len(kvw)], ws[-1]
        else:
            q_w, wo, kv_w = ws[:len(qw)], ws[len(qw)], ws[len(qw) + 1:]
        b, t, _ = hl.shape
        proj = lambda w, bb=None: (hl @ w if bb is None else hl @ w + bb).reshape(b, t, -1, hd)
        q = proj(*q_w)
        k, v = (proj(kv_w[0], kv_w[2]), proj(kv_w[1], kv_w[3])) if cfg.qkv_bias else (proj(kv_w[0]), proj(kv_w[1]))
        if split and not kv_split:  # the kv head of each of this rank's query heads
            pick = (rank * (H // m) + torch.arange(H // m, device=hl.device)) // (H // Hkv)
            k, v = k[:, :, pick], v[:, :, pick]
        q, k = rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta)
        return gqa_attend(q, k, v, mask).reshape(b, t, -1) @ wo

    return tensor_parallel(attend, h, qw + (kvw if kv_split else []), [pa["wo"]], [] if kv_split else kvw,
                           split=split)


def _attn_mlp_block(p, cfg, x, positions, mask, layer_cache, ragged=None, moe=False, enc_kv=None,
                    train=False):
    """Returns (x, aux): aux is the MoE layer's load-balance loss, else None.
    enc_kv: None, or the layer's (cross_k, cross_v), each (B, S_enc, Hkv,
    hd): the cross-attention (no rope, no bias, no mask, the plain
    ``gqa_attend``) follows the self-attention."""
    x = pin(x)
    x = _self_attention(p, cfg, x, positions, mask, layer_cache, ragged, train)
    if enc_kv is not None:
        h = rms_norm(x, p["ln_x"], cfg.norm_eps)
        # on DTensors each rank its rows against the gathered weights: DTensor's own propagation
        # of these products' backward over a 2 x 16 x 16 mesh strides the flattened (B, T)
        x = x + rows_gathered(partial(_cross_attention, cfg), (h, *enc_kv), p["xattn"]["wq"], p["xattn"]["wo"])
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if moe:
        y, aux = moe_apply(p["mlp"], cfg, h, train)
        return x + y, aux
    return x + swiglu(p["mlp"], h), None


def _cross_attention(cfg, h, k, v, wq, wo):
    B, T, _ = h.shape
    q = split_heads(h @ wq, cfg.n_heads, cfg.hd)
    return gqa_attend(q, k, v, None).reshape(B, T, -1) @ wo


def _mixer(apply, p, cfg, h, cache):
    """``apply(p, cfg, h, cache)`` (the SSD or RG-LRU mixer).  On DTensors
    each rank runs it on its rows (and its rows of the cache) against the
    gathered weights: the scans are local to a row, DTensor's strategy
    search for their 4- to 6-D einsums takes minutes a step on a 3-D mesh,
    and its propagation of the products' backward over a 2 x 16 x 16 mesh
    strides the flattened (B, T)."""
    if not isinstance(h, DTensor):
        return apply(p, cfg, h, cache)
    names = list(p)
    return rows_gathered(lambda h, c, *w: apply(dict(zip(names, w)), cfg, h, c), (h, cache), *(p[n] for n in names))


def _rec_block(p, cfg, x, cache):
    x = pin(x)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    y, new_cache = _mixer(rglru_apply, p["rec"], cfg, h, cache)
    x = x + y
    h = rms_norm(x, p["ln_m"], cfg.norm_eps)
    return x + swiglu(p["mlp"], h), new_cache


def _ssm_block(p, cfg, x, cache):
    x = pin(x)
    y, new_cache = _mixer(ssm_apply, p["ssm"], cfg, rms_norm(x, p["ln"], cfg.norm_eps), cache)
    return x + y, new_cache


# ---------------------------------------------------------------- forward ----


def _mk_masks(cfg, mode, T, pos, positions, anc, slots):
    """(full-attention mask, local-window mask) of a pass, each (1 or B, 1,
    T, S): the dense and MoE stacks read the first, the hybrid's attention
    layers the second, and the one a stack does not read is None.

    ``pos`` is the slot->absolute-position table *after* writing the new
    tokens, so queries can see themselves and each other causally.
    """
    hybrid = cfg.arch_type == "hybrid"
    win = cfg.local_window if hybrid else (cfg.window if cfg.attention == "sliding_window" else 0)
    if mode == "full":
        m = causal_mask(T, win, device=positions.device)
    elif mode == "decode":
        m = attn_mask_from_pos(pos, positions, win)
    else:
        m = tree_mask_from_pos(pos, positions, anc, slots, win)
    return (None, m) if hybrid else (m, None)


def _write_pos(pos: torch.Tensor, slots: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """A copy of the slot->position table ``pos`` ((Smax,), or (B, Smax) per
    stream) with ``vals`` written at ``slots`` ((T,) or (B, T))."""
    new_pos = pos.clone()
    if pos.dim() == 2:
        new_pos[torch.arange(pos.shape[0], device=pos.device)[:, None], slots.long()] = vals.to(new_pos.dtype)
    else:
        new_pos[slots.long()] = vals.to(new_pos.dtype)
    return new_pos


def _tree_depths(anc: torch.Tensor, per_stream: bool = False) -> torch.Tensor:
    """Position offsets of tree tokens = (ancestor count - 1).  A (B, T, T)
    anc gives per-row depths (B, T) over a per-stream cache and shares one
    topology (depths from row 0) over a lockstep cache."""
    if anc.dim() == 3 and per_stream:
        return anc.to(torch.int32).sum(dim=-1, dtype=torch.int32) - 1
    a = anc if anc.dim() == 2 else anc[0]
    return a.to(torch.int32).sum(dim=-1, dtype=torch.int32) - 1


def forward(params: dict, cfg, tokens: torch.Tensor | None, *, mode: str = "full",
            cache: dict | None = None, anc: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None, enc_embeds: torch.Tensor | None = None,
            lens: torch.Tensor | None = None, ragged: dict | None = None, train: bool = False):
    """Returns (logits fp32 (B, T, V), new_cache, {"aux": fp32 scalar,
    "hidden": (B, T, d)}); aux sums the MoE layers' load-balance losses (0
    for a dense stack).

    mode "full":   causal pass over tokens; if ``cache`` is given it is
                   filled (prefill), else no cache is built.
    mode "decode": T new tokens against the cache.
    mode "tree":   T speculation-tree tokens with ancestor mask ``anc``
                   ((T, T), or (B, T, T) per row over a per-stream cache).
    embeds:        (B, P, d) modality embeddings.  A VLM given ``tokens``
                   too prepends them, projected by ``patch_proj``: positions
                   and the cache run over the P patches then the tokens.
                   With ``tokens`` None they replace the token embeddings,
                   unprojected, in every family (as in JAX).
    enc_embeds:    (B, S_enc, d) encoder input frames (encdec): the encoder
                   runs unmasked with rope over arange(S_enc), then each
                   decoder layer's cross K/V are projected from its output
                   and, when ``cache`` is given, stored as
                   ``cross_k``/``cross_v`` (n_layers, B, S_enc, Hkv, hd).
                   Without it an encdec pass reads the cache's.
    lens:          (B,) real-token counts of a padded pass over a per-stream
                   cache: row b's tokens past lens[b] are written but marked
                   invalid (pos = -1), and its length advances by lens[b].
    ragged:        the node-major ragged tree pass (mode "tree", no ``anc``)
                   over a PAGED per-stream cache: ``tokens`` is (1, N), every
                   active stream's tree flattened; dict of (N,) int32
                   ``owner`` (pool row), ``parent`` (flat index, -1 root or
                   padding), ``depth``, ``local`` (index within its tree,
                   -1 padding) and (B,) ``counts`` (nodes appended per row).
                   Padding lanes write only the trash block, and their
                   attention reads nothing and gives zeros (the JAX package
                   attends them over row ``owner``); their outputs are
                   discarded.  (The JAX package also runs it over a
                   ring cache, where it drops padding writes; the batched
                   engine here goes ragged on a paged pool only.)
    train:         training semantics (set by ``loss_fn``; no cache): the
                   plain causal attention, the MoE capacity-factor dispatch
                   and, with ``cfg.remat``, each layer (each encoder layer
                   too) recomputed in the backward pass.
    The new K/V are written into ``cache``'s k/v in place (models/cache.py);
    ``new_cache`` shares them and carries new pos/len tensors.  Recurrent
    state (the SSM's ``state``/``conv``, the hybrid's ``rec_*``/``tail_*``)
    comes back as new tensors; it integrates every token of the pass, so
    ``lens`` masks attention state only and the recurrent engines never pad
    (serving/batch_engine.py).
    """
    _check_arch(cfg)
    if train and cache is not None:
        raise ValueError("train=True is a pass without a cache (loss_fn)")
    # each layer is one checkpointed call when remat is on: its activations
    # are recomputed in the backward pass instead of kept
    run = (lambda fn, *a: checkpoint(fn, *a, use_reentrant=False)) if train and cfg.remat else \
        (lambda fn, *a: fn(*a))
    dt = cfg.tdtype
    # on DTensors each rank looks up its own rows in the gathered table: torch 2.11's
    # DTensor rule for the lookup's backward (index_put) fails on an unnormalized dim
    x = rows_gathered(lambda t, e: e[t].to(dt), tokens, params["embed"]) if tokens is not None else embeds.to(dt)
    if cfg.arch_type == "vlm" and embeds is not None and tokens is not None:
        x = torch.cat([(embeds.to(dt) @ params["patch_proj"]).to(dt), x], dim=1)
    B, T, _ = x.shape
    dev = x.device

    enc_kv = None
    if cfg.arch_type == "encdec":
        if enc_embeds is None:  # the cross K/V a prefill cached
            enc_kv = (cache["cross_k"], cache["cross_v"])
        else:
            enc = enc_embeds.to(dt)
            enc_pos = torch.arange(enc.shape[1], dtype=torch.int32, device=dev)
            for layer in _unstack(params["enc_blocks"]):
                enc, _ = run(_attn_mlp_block, layer, cfg, enc, enc_pos, None, None)
            enc = rms_norm(enc, params["enc_ln"], cfg.norm_eps)
            xattn = params["blocks"]["xattn"]
            enc_kv = tuple(torch.stack([split_heads(enc @ wi, cfg.n_kv_heads, cfg.hd)
                                        for wi in xattn[w].unbind(0)]) for w in ("wk", "wv"))

    has_attn = cfg.arch_type != "ssm"
    if cache is None:
        length = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        length = cache["attn"]["len"] if has_attn else cache["len"]
    per_stream = length.dim() == 1
    owner = None
    if ragged is not None:
        if mode != "tree" or anc is not None or lens is not None or cache is None:
            raise ValueError("ragged is a tree pass over a cache, without anc or lens")
        if cfg.arch_type not in ("dense", "moe"):
            raise ValueError(f"the ragged tree pass runs the dense and moe families, not {cfg.arch_type!r}")
        if not (per_stream and "block_tbl" in cache["attn"]):
            raise NotImplementedError("the ragged tree pass needs a paged per-stream cache in this package")
        owner = ragged["owner"]
        q_pos = length[owner.long()] + ragged["depth"]  # (N,) absolute positions
        positions = q_pos[None, :]
    else:
        offs = torch.arange(T, dtype=torch.int32, device=dev) if anc is None else _tree_depths(anc, per_stream)
        positions = length[:, None] + (offs if offs.dim() == 2 else offs[None, :]) if per_stream \
            else length + offs

    new_cache = None if cache is None else dict(cache)
    slots = page_tbl = None
    mask_full = mask_local = None
    if cache is not None and mode == "full":
        mode = "decode"  # prefill == appending T tokens causally to an empty cache
    if has_attn and cache is not None:
        a = cache["attn"]
        page_tbl = a.get("block_tbl")
        smax = a["pos"].shape[-1]
        if ragged is not None:
            local = ragged["local"]
            slots = torch.where(local >= 0, (length[owner.long()] + local.clamp_min(0)) % smax, smax)
            # the sentinel column smax takes the padding lanes' writes and is cut off
            pos_ext = torch.cat([a["pos"], a["pos"].new_full((a["pos"].shape[0], 1), -1)], dim=1)
            pos_ext[owner.long(), slots.long()] = q_pos.to(pos_ext.dtype)
            new_pos = pos_ext[:, :smax].contiguous()
            new_len = length + ragged["counts"]
            win = cfg.window if cfg.attention == "sliding_window" else 0
            mask_full = ragged_tree_mask(new_pos, q_pos, owner, slots, ragged["parent"], win)
            owner = torch.where(local >= 0, owner, -1)  # the kernel skips padding lanes
        else:
            slots = cache_slots(length, T, smax)
            pos_vals = positions
            if lens is not None:
                valid = torch.arange(T, device=dev)[None, :] < lens[:, None]
                pos_vals = torch.where(valid, positions, -1)
            # on DTensors (the dry run over a mesh) on every rank whole: torch 2.11's
            # DTensor has no rule for index_put_
            new_pos = replicated(_write_pos, a["pos"], slots, pos_vals)
            new_len = length + (T if lens is None else lens)
            mask_full, mask_local = _mk_masks(cfg, mode, T, new_pos, positions, anc, slots)
        new_attn = {"k": a["k"], "v": a["v"], "pos": new_pos, "len": new_len.to(torch.int32)}
        if page_tbl is not None:
            new_attn["block_tbl"] = page_tbl
        new_cache["attn"] = new_attn
    elif has_attn:
        mask_full, mask_local = _mk_masks(cfg, "full", T, None, positions, None, None)

    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.arch_type in ATTN_STACKS:
        for i, (pl, moe) in enumerate(_layers(params, cfg)):
            layer_cache = None if cache is None else (cache["attn"]["k"][i], cache["attn"]["v"][i], slots, page_tbl)
            ekv = None if enc_kv is None else (enc_kv[0][i], enc_kv[1][i])
            x, aux = run(_attn_mlp_block, pl, cfg, x, positions, mask_full, layer_cache, owner, moe, ekv, train)
            if aux is not None:
                aux_total = aux_total + aux
        if cache is not None and enc_embeds is not None and cfg.arch_type == "encdec":
            new_cache["cross_k"], new_cache["cross_v"] = enc_kv
    elif cfg.arch_type == "ssm":
        states, convs = [], []
        for i, layer in enumerate(_unstack(params["blocks"])):
            lc = None if cache is None else {"state": cache["state"][i], "conv": cache["conv"][i]}
            x, nc = run(_ssm_block, layer, cfg, x, lc)
            states.append(nc["state"])
            convs.append(nc["conv"])
        if cache is not None:
            new_cache.update(state=torch.stack(states), conv=torch.stack(convs))
    else:  # hybrid: (rec, rec, local-attn) groups, then the recurrent tail
        g = cfg.hybrid_attn_every
        group_states, group_convs = [], []
        for gi, pg in enumerate(_unstack(params["blocks"])):
            states, convs = [], []
            for i in range(g - 1):
                lc = None if cache is None else {"state": cache["rec_state"][gi, i], "conv": cache["rec_conv"][gi, i]}
                x, nc = run(_rec_block, pg[f"rec{i}"], cfg, x, lc)
                states.append(nc["state"])
                convs.append(nc["conv"])
            layer_cache = None if cache is None else (cache["attn"]["k"][gi], cache["attn"]["v"][gi], slots, page_tbl)
            x, _ = run(_attn_mlp_block, pg["attn"], cfg, x, positions, mask_local, layer_cache, None, False,
                       None, train)
            group_states.append(torch.stack(states))
            group_convs.append(torch.stack(convs))
        if cache is not None:
            new_cache.update(rec_state=torch.stack(group_states), rec_conv=torch.stack(group_convs))
        if "tail" in params:
            states, convs = [], []
            for i, layer in enumerate(_unstack(params["tail"])):
                lc = None if cache is None else {"state": cache["tail_state"][i], "conv": cache["tail_conv"][i]}
                x, nc = run(_rec_block, layer, cfg, x, lc)
                states.append(nc["state"])
                convs.append(nc["conv"])
            if cache is not None:
                new_cache.update(tail_state=torch.stack(states), tail_conv=torch.stack(convs))
    if cache is not None and cfg.arch_type in RECURRENT:
        new_cache["len"] = (length + (T if lens is None else lens)).to(torch.int32)

    x = pin(rms_norm(x, params["final_ln"], cfg.norm_eps))
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    # on DTensors each rank's rows against the whole head: DTensor's sharding
    # propagation of this product's backward over a mesh of 16 x 16 fails
    logits = rows_gathered(lambda h, w: (h @ w).float(), x, head)
    return logits, new_cache, {"aux": aux_total, "hidden": x}


# ------------------------------------------------------------------ cache ----


def init_cache(cfg, batch: int, smax: int, device, per_stream: bool = False,
               page: tuple[int, int] | None = None) -> dict:
    """Empty decode cache of the family (models/cache.py layouts).
    per_stream: per-row pos/len tables (the continuous-batching layout).
    page: (pool_blocks, block_size) stores the KV as a paged arena of
    ``pool_blocks`` usable blocks shared through per-row block tables, with
    ``smax`` each row's logical capacity; requires per_stream.  A pure
    recurrent (ssm) cache has no KV and ignores it.  An encdec cache also
    holds zero ``cross_k``/``cross_v`` (n_layers, batch, cfg.enc_len, Hkv,
    hd), which a prefill given ``enc_embeds`` replaces."""
    _check_arch(cfg)
    if page is not None and not per_stream:
        raise ValueError("paged caches are per-stream by construction")
    dt = cfg.tdtype

    def attn_cache(n_layers):
        if page is not None:
            return init_paged_attn_cache(cfg, n_layers, batch, page[0], page[1], smax, dt, device)
        return init_attn_cache(cfg, n_layers, batch, smax, dt, device, per_stream)

    if cfg.arch_type in ATTN_STACKS:
        cache = {"attn": attn_cache(cfg.n_layers)}
        if cfg.arch_type == "encdec":
            shape = (cfg.n_layers, batch, cfg.enc_len, cfg.n_kv_heads, cfg.hd)
            cache["cross_k"] = torch.zeros(shape, dtype=dt, device=device)
            cache["cross_v"] = torch.zeros(shape, dtype=dt, device=device)
        return cache
    cache = {"len": torch.zeros((batch,) if per_stream else (), dtype=torch.int32, device=device)}
    if cfg.arch_type == "ssm":
        H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
        conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        cache["state"] = torch.zeros((cfg.n_layers, batch, H, P, N), dtype=torch.float32, device=device)
        cache["conv"] = torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_dim), dtype=dt, device=device)
        return cache
    g = cfg.hybrid_attn_every
    n_groups, rem = divmod(cfg.n_layers, g)
    dl = cfg.lru_d
    cache["rec_state"] = torch.zeros((n_groups, g - 1, batch, dl), dtype=torch.float32, device=device)
    cache["rec_conv"] = torch.zeros((n_groups, g - 1, batch, 3, dl), dtype=dt, device=device)
    cache["attn"] = attn_cache(n_groups)
    if rem:
        cache["tail_state"] = torch.zeros((rem, batch, dl), dtype=torch.float32, device=device)
        cache["tail_conv"] = torch.zeros((rem, batch, 3, dl), dtype=dt, device=device)
    return cache


# --------------------------------------------------------------- training ----


def loss_fn(params: dict, cfg, tokens: torch.Tensor, labels: torch.Tensor,
            embeds: torch.Tensor | None = None, enc_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Next-token cross-entropy (+ the MoE aux loss x ``router_aux_weight``)
    of a training pass; labels < 0 are masked.  A VLM's logits over its
    prepended patches are left out."""
    logits, _, extras = forward(params, cfg, tokens, mode="full", embeds=embeds, enc_embeds=enc_embeds,
                                train=True)
    if cfg.arch_type == "vlm" and embeds is not None:
        logits = logits[:, embeds.shape[1]:]
    lp = torch.log_softmax(logits, dim=-1)
    mask = labels >= 0
    ll = lp.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    ce = -(ll * mask).sum() / mask.sum().clamp_min(1)
    return ce + cfg.router_aux_weight * extras["aux"]


def loss_and_grads(params: dict, cfg, batch: dict):
    """(loss, grads): ``jax.value_and_grad(loss_fn)`` over every parameter,
    by ``torch.autograd.grad``.  A parameter the pass does not reach gets
    zeros, as ``jax.grad`` gives.  ``batch`` holds ``tokens`` and ``labels``
    and, per family, ``embeds`` or ``enc_embeds``, as tensors on the
    parameters' device.  ``params`` are not modified."""
    live = _map(lambda t: t.detach().requires_grad_(), params)
    leaves = _leaves(live)
    with torch.enable_grad():
        loss = loss_fn(live, cfg, batch["tokens"], batch["labels"], embeds=batch.get("embeds"),
                       enc_embeds=batch.get("enc_embeds"))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(t): torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)}
    del grads
    return loss.detach(), _map(lambda t: by_leaf.pop(id(t)), live)


def make_train_step(cfg, optimizer):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``:
    ``loss_and_grads``, then ``optimizer.update_`` (training/optim.py), which
    writes the new values into ``params`` and ``opt_state`` in place: JAX's
    step is functional, but two copies of float32 moments would not fit a
    card beside a full-width layer's parameters and gradients."""

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, cfg, batch)
        params, opt_state = optimizer.update_(grads, opt_state, params)
        return params, opt_state, loss

    return train_step
