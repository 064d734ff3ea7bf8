"""KV and recurrent-state caches and pools: the counterpart of src/repro/models/cache.py.

Attention caches are ring buffers of size ``Smax``: slot = position % Smax,
with absolute positions stored so masks can express causality uniformly.

Layouts (leading layer axis L):

  * lockstep (``per_stream=False``): ``len`` and ``pos`` shared across the
    batch (the single-stream engine)::

        attn:  k, v: (L, B, Smax, Hkv, hd);  pos: (Smax,) int32;  len: () int32

  * per-stream (``per_stream=True``): every batch row holds an independent
    stream at its own position, the continuous-batching substrate::

        attn:  k, v: (L, B, Smax, Hkv, hd);  pos: (B, Smax);  len: (B,)

  * paged (``init_paged_attn_cache``): KV lives in an arena of fixed-size
    blocks shared by every stream through per-row block tables::

        attn:  k, v: (L, NBLK, block, Hkv, hd);  block_tbl: (B, max_blocks)
               int32, -1 unmapped;  pos: (B, Smax);  len: (B,)

    Logical slot s of row b lives at arena lane (block_tbl[b, s // block],
    s % block).  Physical block 0 is the TRASH block: unmapped entries
    clamp to it, so writes through an unmapped (or idle-row) table land in
    lanes no mask admits (pos stays -1 for unmapped logical slots).

  * recurrent state (leading layer axis L; ``len`` () or (B,))::

        ssm:    state: (L, B, H, P, N) fp32;  conv: (L, B, K-1, C)
        hybrid: rec_state: (G, 2, B, D) fp32;  rec_conv: (G, 2, B, 3, D);
                tail_state: (L % 3, B, D);  tail_conv: (L % 3, B, 3, D);
                attn over the G local-attention layers (ring or paged)

The ring-compaction commit contract is documented in
src/repro/models/cache.py and implemented by
serving/serve_step.make_pool_commit_step.

Where this module writes in place (the JAX package returns new arrays):

  * ``append_layer_kv`` and ``paged_append_layer_kv`` write the new K/V
    into the cache's k/v (or arena) tensors, so a forward pass mutates the
    k/v of the cache it is given, while ``pos``, ``len`` and ``block_tbl``
    come back as new tensors;
  * ``scatter_streams`` writes the rows' k/v into the pool's k/v tensors
    (recurrent leaves are never written in place: every pass and helper
    returns them as new tensors);
  * ``merge_streams`` of two caches that share their k/v tensors (a pass
    and the cache it wrote into) keeps those tensors: a frozen row's write
    stays in its lane.  Every such lane lies at or past the row's ``len``,
    where ``pos`` is -1 until the row itself writes it again (the frontier
    invariant: commits invalidate the whole speculation block, ingest
    passes mark padding lanes -1), so no mask admits it.
A caller that still needs a cache as it was before a pass gives the pass a
copy (``clone_cache``).

Every write that JAX drops with an out-of-range index (``mode="drop"``) is
routed into the trash block or an extra discarded column here instead:
selecting the valid entries with a boolean filter would make a host sync.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

def init_attn_cache(cfg, n_layers: int, batch: int, smax: int, dtype: torch.dtype,
                    device, per_stream: bool = False) -> dict:
    hd = cfg.hd
    return {
        "k": torch.zeros((n_layers, batch, smax, cfg.n_kv_heads, hd), dtype=dtype, device=device),
        "v": torch.zeros((n_layers, batch, smax, cfg.n_kv_heads, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, smax) if per_stream else (smax,), -1, dtype=torch.int32, device=device),
        "len": torch.zeros((batch,) if per_stream else (), dtype=torch.int32, device=device),
    }


def init_paged_attn_cache(cfg, n_layers: int, batch: int, n_blocks: int, block: int,
                          smax: int, dtype: torch.dtype, device) -> dict:
    """Paged attention cache: ``n_blocks`` usable blocks plus the trash
    block 0, and per-row tables of ``smax // block`` columns."""
    if smax % block:
        raise ValueError(f"smax {smax} is not a multiple of the block size {block}")
    hd = cfg.hd
    shape = (n_layers, n_blocks + 1, block, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "block_tbl": torch.full((batch, smax // block), -1, dtype=torch.int32, device=device),
        "pos": torch.full((batch, smax), -1, dtype=torch.int32, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def is_paged(cache: dict) -> bool:
    """True when the cache's attention component is block-table indirect."""
    return "attn" in cache and "block_tbl" in cache["attn"]


def paged_phys_slots(tbl: torch.Tensor, slots: torch.Tensor, block: int) -> torch.Tensor:
    """Flat arena lanes of logical slots.  tbl (B, max_blocks); slots
    (B, T) in [0, max_blocks * block).  Unmapped entries clamp to the trash
    block, so callers may write through them unconditionally."""
    blk = torch.gather(tbl, 1, (slots // block).long())
    return blk.clamp_min(0) * block + slots % block


def paged_append_layer_kv(k_arena, v_arena, k_new, v_new, slots, tbl):
    """Per-layer paged KV write, in place.  k_arena (NBLK, block, Hkv, hd);
    k_new (B, T, Hkv, hd); slots (B, T) logical; tbl (B, max_blocks)."""
    nb, block = k_arena.shape[0], k_arena.shape[1]
    phys = paged_phys_slots(tbl, slots, block).reshape(-1).long()
    kf = k_arena.view((nb * block,) + k_arena.shape[2:])
    vf = v_arena.view((nb * block,) + v_arena.shape[2:])
    kf.index_copy_(0, phys, k_new.reshape((-1,) + k_new.shape[2:]).to(kf.dtype))
    vf.index_copy_(0, phys, v_new.reshape((-1,) + v_new.shape[2:]).to(vf.dtype))
    return k_arena, v_arena


def paged_layer_view(k_arena, v_arena, tbl):
    """The logical (B, Smax, Hkv, hd) view of one layer's arena
    (NBLK, block, Hkv, hd), or (L, B, Smax, Hkv, hd) of a layer-stacked
    arena, as new tensors.  Unmapped blocks read the trash block; their pos
    is -1."""
    phys = tbl.long().clamp_min(0)
    B, nb = phys.shape
    if k_arena.dim() == 5:
        L, block = k_arena.shape[0], k_arena.shape[2]
        return (k_arena[:, phys].reshape((L, B, nb * block) + k_arena.shape[3:]),
                v_arena[:, phys].reshape((L, B, nb * block) + v_arena.shape[3:]))
    block = k_arena.shape[1]
    return (k_arena[phys].reshape((B, nb * block) + k_arena.shape[2:]),
            v_arena[phys].reshape((B, nb * block) + v_arena.shape[2:]))


def cache_slots(length: torch.Tensor, T: int, smax: int) -> torch.Tensor:
    """(T,) ring slots after a scalar length; (B, T) after (B,) lengths."""
    off = torch.arange(T, dtype=torch.int32, device=length.device)
    if length.dim() == 1:
        return (length[:, None] + off[None, :]) % smax
    return (length + off) % smax


def append_layer_kv(k_cache: torch.Tensor, v_cache: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor, slots: torch.Tensor):
    """k_cache (B, Smax, Hkv, hd); k_new (B, T, Hkv, hd); slots (T,) shared
    or (B, T) per stream.  Writes in place and returns the two tensors."""
    if slots.dim() == 2:
        b = torch.arange(k_cache.shape[0], device=k_cache.device)[:, None]
        k_cache[b, slots.long()] = k_new.to(k_cache.dtype)
        v_cache[b, slots.long()] = v_new.to(v_cache.dtype)
        return k_cache, v_cache
    idx = slots.long()
    k_cache.index_copy_(1, idx, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v_new.to(v_cache.dtype))
    return k_cache, v_cache


def attn_mask_from_pos(pos: torch.Tensor, q_positions: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Mask: slot valid iff 0 <= pos[s] <= q_pos[t] (and within the window
    when sliding).  pos (Smax,) or (B, Smax); q_positions (T,) or (B, T).
    Returns (1, 1, T, Smax) or (B, 1, T, Smax)."""
    s = pos[..., None, :]
    t = q_positions[..., :, None]
    m = (s >= 0) & (s <= t)
    if window:
        m = m & (s > t - window)
    return m[:, None] if m.dim() == 3 else m[None, None]


def tree_mask_from_pos(pos: torch.Tensor, q_positions: torch.Tensor, anc: torch.Tensor,
                       self_slots: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Tree-pass mask over cache slots that now *contain* the tree tokens.

    The T tree tokens were appended into ``self_slots``; a tree token may
    attend to (a) any older cache slot per the causal/window rule against
    the branch-context boundary, and (b) its tree ancestors (anc (T, T), or
    (B, T, T): per stream when pos is (B, Smax), else sharing one slot
    table; self included).  Returns (1 or B, 1, T, Smax)."""
    if pos.dim() == 2:  # per-stream tables: pos (B, Smax), self_slots (B, T)
        B, T = self_slots.shape
        base = attn_mask_from_pos(pos, q_positions, window)[:, 0]  # (B, T, Smax)
        bidx = torch.arange(B, device=pos.device)[:, None]
        sl = self_slots.long()
        is_self = torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
        is_self[bidx, sl] = True
        base = base & ~is_self[:, None, :]
        anc_b = anc if anc.dim() == 3 else anc[None].expand(B, T, T)
        tree_part = torch.zeros(base.shape, dtype=torch.bool, device=pos.device)
        tidx = torch.arange(T, device=pos.device)
        tree_part[bidx[:, :, None], tidx[None, :, None], sl[:, None, :]] = anc_b.bool()
        return (base | tree_part)[:, None]
    base = attn_mask_from_pos(pos, q_positions, window)[0, 0]  # (T, Smax)
    idx = self_slots.long()
    # cut out the tree's own slots from the causal rule, then re-add ancestors
    is_self = torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
    is_self[idx] = True
    base = base & ~is_self[None, :]
    if anc.dim() == 3:
        tree_part = torch.zeros((anc.shape[0],) + base.shape, dtype=torch.bool, device=pos.device)
        tree_part[:, :, idx] = anc.bool()
        return (base[None] | tree_part)[:, None]
    tree_part = torch.zeros(base.shape, dtype=torch.bool, device=pos.device)
    tree_part[:, idx] = anc.bool()
    return (base | tree_part)[None, None]


def ancestor_closure(direct: torch.Tensor) -> torch.Tensor:
    """Ancestor-or-self masks from parent edges.  direct (..., n, n) bool
    with direct[i, j] iff j is i or i's parent.  Repeated squaring of the
    reachability matrix (exact: the products count paths), ceil(log2 n)
    products instead of the JAX package's n chase steps."""
    n = direct.shape[-1]
    a = direct.float()
    for _ in range(max(n - 1, 1).bit_length()):
        a = ((a @ a) > 0).float()
    return a > 0


def ragged_tree_mask(pos: torch.Tensor, q_pos: torch.Tensor, owner: torch.Tensor,
                     slots: torch.Tensor, parent: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Tree-pass mask of the RAGGED node-major layout, (N, Smax).

    ``owner[i]`` is node i's pool row, ``slots[i]`` its ring slot in that
    row (``Smax`` for padding lanes, a sentinel that writes nothing),
    ``parent[i]`` its FLAT parent index (-1 for roots and padding) and
    ``q_pos[i]`` its absolute position; ``pos`` is the (B, Smax) table
    after writing the tree tokens.  Row i admits, over its owner row,
    committed slots by the causal/window rule plus the slots of its
    flat-tree ancestors (self included)."""
    N = owner.shape[0]
    smax = pos.shape[-1]
    dev = pos.device
    ow, sl = owner.long(), slots.long()
    p = pos[ow]  # (N, Smax)
    base = (p >= 0) & (p <= q_pos[:, None])
    if window:
        base = base & (p > q_pos[:, None] - window)
    # the sentinel column smax takes the padding lanes' writes and is cut off
    is_self = torch.zeros((pos.shape[0], smax + 1), dtype=torch.bool, device=dev)
    is_self[ow, sl] = True
    base = base & ~is_self[ow, :smax]
    idx = torch.arange(N, device=dev)
    direct = (idx[None, :] == idx[:, None]) | (idx[None, :] == parent.long()[:, None])
    anc = ancestor_closure(direct)
    # OR-scatter ancestor admits into slot columns (a count, then > 0): two
    # streams may reuse one slot value, and a foreign node's False must not
    # wipe the owner's True
    hits = torch.zeros((N, smax + 1), dtype=torch.int32, device=dev)
    hits.scatter_add_(1, sl[None, :].expand(N, N), anc.to(torch.int32))
    return base | (hits[:, :smax] > 0)


# ---------------------------------------------------------- stream algebra ---
#
# Every cache tensor has at most one stream (batch) axis, whose position
# depends on the family (src/repro/models/cache.py ``_walk``):
#
#   attn k/v: 1;  attn pos/len: 0 per stream, none lockstep;
#   state, conv, tail_state, tail_conv (ssm, hybrid tail): 1;
#   rec_state, rec_conv (the hybrid's groups): 2;  cross_k, cross_v (the
#   encoder-decoder's cached encoder K/V): 1;  top-level len: 0 per stream,
#   none lockstep.
#
# The helpers below return new tensors for every leaf except where they say
# so: scatter_streams writes the pool's attention k/v in place.

_AXIS1 = ("state", "conv", "tail_state", "tail_conv", "cross_k", "cross_v")


def _axis(key: str, t: torch.Tensor, in_attn: bool):
    """The stream axis of leaf ``key`` (inside ``attn`` or at the top level),
    None for a lockstep pos/len."""
    if in_attn and key in ("k", "v"):
        return 1
    if in_attn and key == "pos":
        return 0 if t.dim() == 2 else None
    if key == "len":
        return 0 if t.dim() == 1 else None
    if key in ("rec_state", "rec_conv"):
        return 2
    if key in _AXIS1:
        return 1
    raise KeyError(f"cache leaf {key!r} has no known stream axis")


def _walk(cache: dict, other: dict | None, fn) -> dict:
    """fn(tensor, other's tensor or None, name, stream axis or None) over
    every leaf, block_tbl excluded (paged attention is handled apart)."""
    out = {}
    for key, val in cache.items():
        o = None if other is None else other[key]
        if key == "attn":
            out[key] = {n: fn(t, None if o is None else o[n], n, _axis(n, t, True))
                        for n, t in val.items() if n != "block_tbl"}
        else:
            out[key] = fn(val, o, key, _axis(key, val, False))
    return out


def _rest(cache: dict) -> dict:
    """Every leaf but the attention component (handled apart when paged)."""
    return {key: val for key, val in cache.items() if key != "attn"}


def _rows_tensor(rows, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(rows, np.int64), device=device)


def _paged_gather_attn(attn: dict, rows: torch.Tensor) -> dict:
    """Selected paged rows as a DENSE per-stream attn cache (new tensors)."""
    tblr = attn["block_tbl"][rows]
    kd, vd = paged_layer_view(attn["k"], attn["v"], tblr)
    return {"k": kd, "v": vd, "pos": attn["pos"][rows], "len": attn["len"][rows]}


def _paged_scatter_attn(attn: dict, rows_attn: dict, slots: torch.Tensor) -> dict:
    """Write dense per-stream rows back through the block tables, k/v in
    place.  Content of logical blocks a row has not mapped lands in the
    trash block."""
    phys = attn["block_tbl"][slots].long().clamp_min(0)  # (R, nb)
    R, nb = phys.shape
    k, v = attn["k"], attn["v"]
    block = k.shape[2]
    k[:, phys] = rows_attn["k"].reshape((k.shape[0], R, nb, block) + k.shape[3:]).to(k.dtype)
    v[:, phys] = rows_attn["v"].reshape((v.shape[0], R, nb, block) + v.shape[3:]).to(v.dtype)
    pos, length = attn["pos"].clone(), attn["len"].clone()
    pos[slots] = rows_attn["pos"].to(pos.dtype)
    length[slots] = rows_attn["len"].to(length.dtype)
    return {"k": k, "v": v, "pos": pos, "len": length, "block_tbl": attn["block_tbl"]}


def _device(cache: dict):
    leaf = cache["attn"]["k"] if "attn" in cache else cache["len"]
    return leaf.device


def gather_streams(cache: dict, rows) -> dict:
    """Select stream rows (a smaller cache over ``rows``, in order; new
    tensors).  Paged caches come back DENSE: per-stream rings over the
    rows' logical views, which ``scatter_streams`` writes back."""
    rows = _rows_tensor(rows, _device(cache))

    def take(t, _, name, ax):
        return t if ax is None else t.index_select(ax, rows)

    if is_paged(cache):
        out = _walk(_rest(cache), None, take)
        out["attn"] = _paged_gather_attn(cache["attn"], rows)
        return out
    return _walk(cache, None, take)


def fork_streams(cache: dict, K: int) -> dict:
    """Replicate every stream row K times along its stream axis (row b maps
    to rows b*K .. b*K+K-1), as new tensors, so passes over the fork leave
    the parent untouched.  Lockstep pos/len are shared, not replicated.  A
    paged cache is first gathered to its dense per-stream view: forked
    branches write independent speculative KV, which a shared arena cannot
    hold."""
    if is_paged(cache):
        n = cache["attn"]["len"].shape[0]
        cache = gather_streams(cache, range(n))
    return _walk(cache, None, lambda t, _, n, ax: t if ax is None else t.repeat_interleave(K, dim=ax))


def scatter_streams(pool: dict, rows_cache: dict, slots) -> dict:
    """Write ``rows_cache`` stream rows into ``pool`` at ``slots`` (pool row
    indices, one per rows_cache row): the attention k/v in place, every
    other leaf (pos/len, recurrent state) as a new tensor.  A paged pool
    takes dense per-stream rows (the ``gather_streams`` layout) and routes
    them through its block tables."""
    slots = _rows_tensor(slots, _device(pool))

    def put(dst, src, name, ax):
        if ax is None:
            return dst
        if name not in ("k", "v"):
            dst = dst.clone()
        dst.index_copy_(ax, slots, src.to(dst.dtype))
        return dst

    if is_paged(pool):
        out = _walk(_rest(pool), _rest(rows_cache), put)
        out["attn"] = _paged_scatter_attn(pool["attn"], rows_cache["attn"], slots)
        return out
    return _walk(pool, rows_cache, put)


def concat_streams(caches: list[dict]) -> dict:
    """Concatenate per-stream caches along their stream axis (new tensors).
    Tensors without a stream axis are taken from the first cache.  Used to
    fuse a step's row groups into one ``scatter_streams``."""
    out = {}
    for key, val in caches[0].items():
        if key == "attn":
            out[key] = {n: t if _axis(n, t, True) is None else torch.cat([c[key][n] for c in caches],
                                                                          _axis(n, t, True))
                        for n, t in val.items() if n != "block_tbl"}
        else:
            ax = _axis(key, val, False)
            out[key] = val if ax is None else torch.cat([c[key] for c in caches], ax)
    return out


def merge_streams(new: dict, old: dict, keep) -> dict:
    """Per-stream select: row b of the result is ``new``'s where keep[b],
    else ``old``'s.  The freeze primitive of padded lockstep stepping: rows
    whose stream has no real token this step keep their exact prior state.

    k/v that ``new`` shares with ``old`` (a pass wrote into the cache it was
    given) are kept as they are: the frozen rows' writes stay in lanes whose
    pos is -1 (module docstring).  Distinct tensors are selected by row, or,
    for the k/v of a paged arena, by physical block (a block takes
    ``new``'s content iff a keep row maps it)."""
    keep = torch.as_tensor(keep, device=_device(new)).bool()

    def sel(n, o, name, ax):
        if n is o or ax is None:
            return n
        shape = [1] * n.dim()
        shape[ax] = keep.shape[0]
        return torch.where(keep.reshape(shape), n, o)

    if not is_paged(new):
        return _walk(new, old, sel)
    out = _walk(_rest(new), _rest(old), sel)
    an, ao = new["attn"], old["attn"]
    tbl = an["block_tbl"]
    attn = {"pos": sel(an["pos"], ao["pos"], "pos", 0), "len": sel(an["len"], ao["len"], "len", 0),
            "block_tbl": torch.where(keep[:, None], tbl, ao["block_tbl"])}
    if an["k"] is ao["k"] and an["v"] is ao["v"]:
        attn["k"], attn["v"] = an["k"], an["v"]
    else:
        owned = torch.zeros((an["k"].shape[1],), dtype=torch.int32, device=tbl.device)
        owned.index_add_(0, tbl.long().clamp_min(0).reshape(-1),
                         (keep[:, None] & (tbl >= 0)).to(torch.int32).reshape(-1))
        bsel = (owned > 0)[None, :, None, None, None]
        attn["k"] = torch.where(bsel, an["k"], ao["k"])
        attn["v"] = torch.where(bsel, an["v"], ao["v"])
    out["attn"] = attn
    return out


def clone_cache(cache: dict) -> dict:
    """A copy a forward pass (or a scatter) may write without touching
    ``cache``: the attention k/v, the only tensors this package writes in
    place, are copied; every other leaf is shared (each write of it makes a
    new tensor).  The encoder-decoder's ``cross_k``/``cross_v`` are shared
    too: only a prefill given the encoder's input writes them, and it makes
    new tensors."""
    out = dict(cache)
    if "attn" in cache:
        out["attn"] = {**cache["attn"], "k": cache["attn"]["k"].clone(), "v": cache["attn"]["v"].clone()}
    return out


# ------------------------------------------------------------------ pools ---


class CachePool:
    """Fixed-capacity slot pool over a per-stream cache: one batched cache
    of ``n_slots`` rows plus free-row bookkeeping, so streams join (prefill a
    1-row cache, scatter it in) and leave (release the row) while every
    model call sees the same (n_slots, ...) shapes.  Rows are handed out
    lowest index first.  A pure recurrent (ssm) cache, which has no
    attention component, is always this ring pool.

    ``rows`` (lo, hi): the pool's rows [lo, hi) of ``n_slots`` live in
    ``cache`` (one rank's part of a pool split over a data mesh; by default
    all of them).  Slot ids, the free-row list and, paged, the block tables
    and the block free list stay global: host state, the same on every rank.
    Every method takes global slot ids and touches the device rows of its
    own range only; ``admit`` of a row another rank holds takes no row
    cache (None) and only books the row.

    Frames (the pipelined engine's rewind of a recurrent draft pool):
    between ``begin_frame()`` and ``drop_frame()`` the pool holds a back
    frame, the cache as of the frame start, and ``rollback_frame()``
    restores it.  JAX's frame is a reference to an immutable pytree; here
    the ingest writes the pool's attention k/v in place, so the frame is a
    ``clone_cache`` copy (k/v copied, every other leaf shared: it is only
    ever replaced)."""

    def __init__(self, cache: dict, n_slots: int, rows: tuple[int, int] | None = None):
        self.cache = cache
        self.n_slots = n_slots
        self.lo, self.hi = rows if rows is not None else (0, n_slots)
        self._free = list(range(n_slots))
        self._back: dict | None = None

    def holds(self, slot: int) -> bool:
        """Whether row ``slot`` lives in this pool's ``cache``."""
        return self.lo <= slot < self.hi

    def _local_starts(self, starts: dict) -> dict:
        """{global row: value} restricted to the rows held here, keyed by
        their index in ``cache``."""
        return {s - self.lo: v for s, v in starts.items() if self.holds(s)}

    @property
    def frame_held(self) -> bool:
        return self._back is not None

    def begin_frame(self) -> None:
        """Hold a copy of the current cache as the back frame (one at a time)."""
        if self._back is not None:
            raise RuntimeError("frame already held")
        self._back = clone_cache(self.cache)

    def drop_frame(self) -> None:
        """Release the back frame (the step it guarded is being finished)."""
        self._back = None

    def rollback_frame(self) -> None:
        """Restore the back frame as the live cache: every write since
        ``begin_frame`` is discarded."""
        if self._back is None:
            raise RuntimeError("no frame to roll back")
        self.cache, self._back = self._back, None

    def invalidate_from(self, starts: dict[int, int]) -> None:
        """Erase rows' speculative attention writes: for each {row: start},
        set pos = -1 on every lane holding a position >= start and rewind
        the row's len to start.  The orphaned KV lanes keep their content,
        barred from every mask by pos = -1."""
        starts = self._local_starts(starts)
        if not starts:
            return
        attn = dict(self.cache["attn"])
        dev = attn["pos"].device
        rows = torch.as_tensor(np.fromiter(starts.keys(), np.int64), device=dev)
        st = torch.as_tensor(np.fromiter(starts.values(), np.int32), device=dev)
        pos, length = attn["pos"].clone(), attn["len"].clone()
        sub = pos[rows]
        pos[rows] = torch.where(sub >= st[:, None], -1, sub)
        length[rows] = st
        attn["pos"], attn["len"] = pos, length
        self.cache = {**self.cache, "attn": attn}

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def next_slot(self) -> int | None:
        """The row ``acquire`` would hand out next (None when full)."""
        return self._free[0] if self._free else None

    def acquire(self) -> int:
        if not self._free:
            raise RuntimeError("cache pool exhausted")
        return self._free.pop(0)

    def release(self, slot: int) -> None:
        if slot in self._free:
            raise ValueError(f"row {slot} released twice")
        self._free.append(slot)
        self._free.sort()

    def _write_row(self, slot: int, row_cache: dict | None) -> None:
        """Scatter a 1-row cache into row ``slot``: given exactly when the
        row is held here."""
        if (row_cache is not None) != self.holds(slot):
            raise ValueError(f"row {slot} {'is' if self.holds(slot) else 'is not'} held in rows "
                             f"[{self.lo}, {self.hi}): its row cache must be {'given' if self.holds(slot) else 'None'}")
        if row_cache is not None:
            self.cache = scatter_streams(self.cache, row_cache, [slot - self.lo])

    def admit(self, row_cache: dict | None, ctx_len: int = 0) -> int:
        """Scatter a freshly prefilled 1-row per-stream cache into a free row
        (None for a row held elsewhere)."""
        slot = self.acquire()
        self._write_row(slot, row_cache)
        return slot


class PagedCachePool(CachePool):
    """The CachePool API over a block arena.

    Streams own blocks from a shared free list, a min-heap so allocation is
    lowest id first (block 0 is the trash block and never handed out).  The
    host mirrors the block tables, so allocation never reads device memory;
    every table change pushes one small (n_slots, max_blocks) int32 copy.

      * ``admit(row, ctx_len)`` maps blocks for the prefilled context, then
        scatters the dense row through the table;
      * ``ensure(slot, upto)`` maps unmapped logical blocks covering
        [0, upto) before a step's writes;
      * ``reclaim_tail(slot, keep_upto)`` unmaps blocks wholly past a
        stream's live frontier;
      * ``release(slot)`` returns every block to the free list.
    """

    def __init__(self, cache: dict, n_slots: int, rows: tuple[int, int] | None = None):
        super().__init__(cache, n_slots, rows)
        if not is_paged(cache):
            raise ValueError("PagedCachePool needs a paged attn cache")
        attn = self.cache["attn"]
        self.block = int(attn["k"].shape[2])
        self.max_blocks = int(attn["block_tbl"].shape[1])
        self.total_blocks = int(attn["k"].shape[1]) - 1  # minus trash
        self._tbl = np.full((n_slots, self.max_blocks), -1, np.int32)
        self._free_blocks = list(range(1, self.total_blocks + 1))  # sorted, hence a heap
        self._pending_pos: dict[int, int] = {}  # deferred pos resets (reclaim_tails)

    @property
    def free_blocks(self) -> int:
        return len(self._free_blocks)

    @property
    def used_blocks(self) -> int:
        return self.total_blocks - len(self._free_blocks)

    def blocks_for(self, upto: int) -> int:
        """Logical blocks covering slots [0, upto)."""
        return min(-(-max(upto, 0) // self.block), self.max_blocks)

    def missing_blocks(self, slot: int, upto: int) -> int:
        """How many of the blocks covering [0, upto) row ``slot`` has yet to map."""
        return int(np.sum(self._tbl[slot, :self.blocks_for(upto)] < 0))

    def occupancy(self, frontiers=None) -> dict:
        """Arena counters: blocks used/free and internal fragmentation
        (mapped slots holding no live token, as a share of mapped slots).
        ``frontiers`` maps row -> live slot count."""
        used = self.used_blocks
        frag = 0.0
        if frontiers and used:
            mapped = sum(int(np.sum(self._tbl[s] >= 0)) for s in frontiers) * self.block
            live = sum(min(f, self.max_blocks * self.block) for f in frontiers.values())
            frag = max(0.0, 1.0 - live / mapped) if mapped else 0.0
        return {"blocks_total": self.total_blocks, "blocks_used": used, "blocks_free": self.free_blocks,
                "block_size": self.block, "fragmentation": frag}

    def _sync_tbl(self) -> None:
        attn = dict(self.cache["attn"])
        attn["block_tbl"] = torch.tensor(self._tbl[self.lo:self.hi], device=attn["block_tbl"].device)  # a copy
        self.cache = {**self.cache, "attn": attn}

    def ensure(self, slot: int, upto: int, sync: bool = True) -> bool:
        """Map every unmapped logical block covering [0, upto).  Returns
        False (mapping nothing) when the free list is too short.
        ``sync=False`` defers the device table push (``ensure_rows``)."""
        idx = [i for i in range(self.blocks_for(upto)) if self._tbl[slot, i] < 0]
        if len(idx) > len(self._free_blocks):
            return False
        if idx:
            for i in idx:
                self._tbl[slot, i] = heapq.heappop(self._free_blocks)
            if sync:
                self._sync_tbl()
        return True

    def ensure_rows(self, frontiers: dict) -> bool:
        """``ensure`` for every {slot: upto} with ONE table push."""
        ok = True
        for slot, upto in frontiers.items():
            ok = self.ensure(slot, upto, sync=False) and ok
        self._sync_tbl()
        return ok

    def _reset_pos_tails(self, starts: dict) -> None:
        """pos[slot, start:] = -1 for every {slot: start}, in one round."""
        starts = self._local_starts(starts)
        if not starts:
            return
        attn = dict(self.cache["attn"])
        dev = attn["pos"].device
        rows = np.fromiter(starts.keys(), np.int64)
        st = np.fromiter((starts[r] for r in rows), np.int64)
        smax = attn["pos"].shape[1]
        dead = torch.as_tensor(np.arange(smax)[None, :] >= st[:, None], device=dev)
        rows_t = torch.as_tensor(rows, device=dev)
        pos = attn["pos"].clone()
        pos[rows_t] = torch.where(dead, -1, pos[rows_t])
        attn["pos"] = pos
        self.cache = {**self.cache, "attn": attn}

    def reclaim_tail(self, slot: int, keep_upto: int, sync: bool = True) -> int:
        """Unmap mapped blocks wholly past the row's live frontier and return
        them to the free list; reset the freed slots' pos to -1.
        ``sync=False`` defers the push and the reset (``reclaim_tails``)."""
        first = self.blocks_for(keep_upto)
        freed = [i for i in range(first, self.max_blocks) if self._tbl[slot, i] >= 0]
        if not freed:
            return 0
        for i in freed:
            heapq.heappush(self._free_blocks, int(self._tbl[slot, i]))
            self._tbl[slot, i] = -1
        if sync:
            self._sync_tbl()
            self._reset_pos_tails({slot: freed[0] * self.block})
        else:
            self._pending_pos[slot] = min(freed[0] * self.block, self._pending_pos.get(slot, 1 << 30))
        return len(freed)

    def reclaim_tails(self, frontiers: dict) -> int:
        """``reclaim_tail`` over {slot: keep_upto} with one table push and
        one pos reset."""
        self._pending_pos = {}
        freed = sum(self.reclaim_tail(s, keep, sync=False) for s, keep in frontiers.items())
        if freed:
            self._sync_tbl()
            self._reset_pos_tails(self._pending_pos)
        self._pending_pos = {}
        return freed

    def release(self, slot: int) -> None:
        owned = self._tbl[slot][self._tbl[slot] >= 0]
        if owned.size:
            for b in owned:
                heapq.heappush(self._free_blocks, int(b))
            self._tbl[slot] = -1
            self._sync_tbl()
        super().release(slot)

    def admit(self, row_cache: dict | None, ctx_len: int = 0) -> int:
        """Acquire a row, map blocks for the prefilled context, scatter the
        dense row through the table (None: a row held elsewhere).  An
        exhausted free list here is a scheduling bug: callers gate on
        ``free_blocks`` first."""
        slot = self.acquire()
        if not self.ensure(slot, ctx_len):
            super().release(slot)
            raise RuntimeError(f"paged pool out of blocks admitting a {ctx_len}-token context "
                               f"({self.free_blocks} free)")
        self._write_row(slot, row_cache)
        return slot


def make_cache_pool(cache: dict, n_slots: int, rows: tuple[int, int] | None = None) -> CachePool:
    """Paged pools for paged caches, ring pools otherwise; ``rows`` as in
    ``CachePool``."""
    return (PagedCachePool if is_paged(cache) else CachePool)(cache, n_slots, rows)
