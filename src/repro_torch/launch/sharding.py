"""Parameter, optimizer, batch, cache and KV-pool sharding rules.

The counterpart of src/repro/launch/sharding.py.  A leaf's spec is JAX's
``PartitionSpec`` as a tuple with one entry per tensor dim: None
(replicated), a mesh axis name, or a tuple of names (that dim split over
several axes, major to minor).  ``placements`` turns a spec into the
``torch.distributed.tensor`` placements of a ``DeviceMesh`` (``Shard(d)`` on
each mesh dim that splits tensor dim d, ``Replicate()`` on the others), and
``distribute`` places a tree of tensors by a tree of specs.

Scheme (JAX's): 2D FSDP x tensor-parallel.
  * up-projections  (.., d_in, d_out): d_in -> data (FSDP), d_out -> model (TP)
  * down-projections (.., d_in, d_out): d_in -> model, d_out -> data
  * MoE experts (L, E, ..): E -> model (expert parallel), dense dim -> data
  * per-channel vectors (biases, A_log, conv): last dim -> model
  * embeddings (V, D): V -> model, D -> data  (falls back when V % model != 0)
  * norms and scalars: replicated
  * the pod axis never shards parameters (pure data parallel across pods)

Every parameter rule is divisibility-guarded: an axis that does not divide
is dropped (replicated), and each drop is logged once per (param class,
axis).  The KV-pool stream axis (``pool_specs``/``pool_shardings``) is the
exception: a stream axis that does not divide the data axis is an error
(pad ``n_slots`` up with ``pad_slots``).
"""
from __future__ import annotations

import logging
import math
import re

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.launch.mesh import data_axes, mesh_axes

_log = logging.getLogger(__name__)
_logged_drops: set[tuple[str, str]] = set()

# (param-name regex, spec template of the TRAILING dims); leading layer or
# group axes are replicated
_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    (r"embed$", ("model", "data")),
    (r"lm_head$", ("data", "model")),
    (r"patch_proj$", ("data", "model")),
    (r"(wq|wk|wv)$", ("data", "model")),
    (r"wo$", ("model", "data")),
    (r"(bq|bk|bv)$", ("model",)),
    (r"router$", ("data", None)),
    (r"(w_gate|w_up)$", ("data", "model")),       # dense mlp (d, f)
    (r"w_down$", ("model", "data")),              # dense mlp (f, d)
    (r"w_in$", ("data", "model")),
    (r"w_out$", ("model", "data")),
    (r"(w_x|w_y)$", ("data", "model")),
    (r"(w_a|w_i)$", ("model", None, None)),  # block-diagonal (nb, bd, bd)
    (r"conv_w$", (None, "model")),
    (r"(conv_b|A_log|dt_bias|lam|norm_z|b_a|b_i)$", ("model",)),
    (r"^D$", ("model",)),
]
# MoE expert tensors (told apart by ndim): (L, E, d, f) / (L, E, f, d)
_MOE_RULES = {
    "w_gate": ("model", "data", None),
    "w_up": ("model", "data", None),
    "w_down": ("model", None, "data"),
}


def placements(mesh, spec: tuple) -> tuple:
    """The DTensor placements of ``spec`` over ``mesh`` (a ``DeviceMesh`` or
    its axes): on each mesh dim, ``Shard(d)`` where tensor dim d's entry
    names it, else ``Replicate()``.  A tuple entry shards its dim on each of
    its axes in mesh-dim order, which is JAX's major-to-minor order."""
    out = []
    for name in mesh_axes(mesh):
        dims = [d for d, ax in enumerate(spec) if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def local_shape(shape, mesh, spec: tuple) -> tuple[int, ...]:
    """Each rank's shape of a leaf of ``shape`` under ``spec`` (every rule
    here splits evenly): JAX's ``NamedSharding.shard_shape``."""
    axes = mesh_axes(mesh)
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        names = () if ax is None else (ax,) if isinstance(ax, str) else ax
        out.append(dim // math.prod(axes[n] for n in names))
    return tuple(out)


def _spec_for(path: str, shape: tuple, mesh, cfg=None) -> tuple:
    axes = mesh_axes(mesh)
    name = path.split("/")[-1]
    ndim = len(shape)
    tmpl = None
    if name in _MOE_RULES and ndim == 4:
        tmpl = _MOE_RULES[name]
    else:
        for pat, t in _RULES:
            if re.search(pat, name):
                tmpl = t
                break
    if tmpl is None or len(tmpl) > ndim:
        return (None,) * ndim
    tmpl = list(tmpl)
    # head-aware guard: tensor parallelism tiles whole (kv-)heads, never
    # splits inside one
    if cfg is not None and "model" in axes and getattr(cfg, "n_heads", 0):
        msize = axes["model"]
        if re.search(r"(wk|wv|bk|bv)$", name) and cfg.n_kv_heads % msize != 0:
            tmpl = [None if a == "model" else a for a in tmpl]
        if re.search(r"(wq|bq|wo)$", name) and cfg.n_heads % msize != 0:
            tmpl = [None if a == "model" else a for a in tmpl]
    full = (None,) * (ndim - len(tmpl)) + tuple(tmpl)
    # divisibility guard: drop (replicate) the axis, and say so once per
    # param class, so that a mis-sized mesh cannot silently replicate half
    # the model
    out = []
    for dim, ax in zip(shape, full):
        if ax is None or ax not in axes or dim % axes[ax] != 0:
            if ax is not None and ax in axes and (name, ax) not in _logged_drops:
                _logged_drops.add((name, ax))
                _log.warning("sharding: param class %r drops axis %r (dim %d %% %s=%d != 0) -> replicated "
                             "on that dim", name, ax, dim, ax, axes[ax])
            out.append(None)
        else:
            out.append(ax)
    return tuple(out)


def _map_path(fn, tree, prefix=""):
    return {k: _map_path(fn, v, f"{prefix}{k}/") if isinstance(v, dict) else fn(prefix + k, v)
            for k, v in tree.items()}


def param_shardings(mesh, params, cfg=None, mode: str = "train") -> dict:
    """The spec of every parameter leaf (tensors, fake or real, give the
    shapes).

    mode "train": 2D FSDP x TP (weights also sharded on the data axis and
                  gathered a layer at a time).
    mode "serve": pure TP: weights sharded on "model" only and replicated
                  across data (decode reads the weights once a token; a
                  per-step FSDP gather would dominate it)."""
    if mode not in ("train", "serve"):
        raise ValueError(f"mode is 'train' or 'serve', not {mode!r}")

    def assign(path, leaf):
        spec = _spec_for(path, tuple(leaf.shape), mesh, cfg)
        if mode == "serve":
            spec = tuple(None if ax == "data" or (isinstance(ax, tuple) and "data" in ax) else ax for ax in spec)
        return spec

    return _map_path(assign, params)


def opt_shardings(mesh, param_sh: dict) -> dict:
    """AdamW's state: ``mu``/``nu`` mirror the parameters; the step count
    is a host int here (replicated, as JAX's ``P()``)."""
    return {"step": (), "mu": param_sh, "nu": param_sh}


def batch_spec(mesh) -> tuple:
    axes = data_axes(mesh)
    return (axes if len(axes) > 1 else axes[0],)


def batch_shardings(mesh, batch: dict) -> dict:
    """The leading batch dim of every batch leaf on the data axes, where it
    divides (else replicated)."""
    axes = mesh_axes(mesh)
    total = math.prod(axes[a] for a in data_axes(mesh))
    lead = batch_spec(mesh)
    return _map_path(lambda _, t: (lead + (None,) * (t.dim() - 1)) if t.dim() and t.shape[0] % total == 0
                     else (None,) * t.dim(), batch)


def cache_shardings(mesh, cache: dict, *, batch_sharded: bool) -> dict:
    """Decode-cache specs.  Attention k/v (L, B, S, Hkv, hd): batch -> data
    when divisible; the slot axis S -> model (flash-decode split-S).
    Recurrent states (L, B, H, P, N): batch -> data, heads -> model.
    pos/len replicated."""
    axes = mesh_axes(mesh)
    dax = data_axes(mesh)
    dsize = math.prod(axes[a] for a in dax)
    msize = axes["model"]
    daxis = dax if len(dax) > 1 else dax[0]

    def assign(path, leaf):
        name = path.split("/")[-1]
        shp = tuple(leaf.shape)
        b = lambda i: daxis if batch_sharded and shp[i] % dsize == 0 else None
        m = lambda ok: "model" if ok else None
        if name in ("k", "v", "cross_k", "cross_v"):
            return (None, b(1), m(shp[2] % msize == 0), None, None)
        if name == "state":  # (L, B, H, P, N)
            return (None, b(1), m(shp[2] % msize == 0)) + (None,) * (len(shp) - 3)
        if name == "conv":  # (L, B, K-1, C)
            return (None, b(1)) + (None,) * (len(shp) - 3) + (m(shp[-1] % msize == 0),)
        if name in ("rec_state", "rec_conv"):  # (G, g-1, B, ..., D)
            return (None, None, b(2)) + (None,) * (len(shp) - 4) + (m(shp[-1] % msize == 0),)
        if name in ("tail_state", "tail_conv"):  # (rem, B, ..., D)
            return (None, b(1)) + (None,) * (len(shp) - 3) + (m(shp[-1] % msize == 0),)
        return (None,) * len(shp)  # pos, len, block tables

    return _map_path(assign, cache)


def distribute(tree, mesh: DeviceMesh, specs):
    """Each leaf of ``tree`` as a DTensor placed by its spec.  Rank 0's
    values are scattered (``distribute_tensor``'s default), so every rank
    holds the shards of one draw however each drew it.  A leaf that is
    already a DTensor, or no tensor, stays as it is."""
    if isinstance(tree, dict):
        return {k: distribute(v, mesh, specs[k]) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor) or isinstance(tree, DTensor):
        return tree
    return distribute_tensor(tree, mesh, placements(mesh, specs))


def gather(tree):
    """Every DTensor leaf of ``tree`` whole (``full_tensor``), other leaves
    as they are.  A collective: every rank of the mesh calls it."""
    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


# ------------------------------------------------------- KV-pool stream axis ---


def pad_slots(n_slots: int, data: int) -> int:
    """Round ``n_slots`` up to a multiple of the data axis.

    The pool's stream axis must divide the data axis exactly (``pool_specs``):
    a shard that cannot take a whole slice would have to be replicated,
    doubling its pool memory and breaking the shard-local free list, while
    idle rows only cost padding lanes."""
    if n_slots < 1 or data < 1:
        raise ValueError(f"n_slots {n_slots} and data {data} must be >= 1")
    return -(-n_slots // data) * data


def pool_specs(mesh_axes: dict, cache: dict) -> dict:
    """The stream axis of every leaf of a per-stream cache pool
    (models/cache.py), or None for a leaf that replicates.

    The stream axis: attention k/v axis 1, pos/len/block_tbl axis 0,
    state/conv/tail_* axis 1, the hybrid's rec_* axis 2.  A paged arena
    ((L, NBLK + 1, block, Hkv, hd)) has no stream axis and replicates: the
    sharded engine gives every shard a private arena and free list instead.
    Unlike a parameter rule, the stream axis is never dropped: a pool whose
    ``n_slots`` does not divide the data axis is an error (pad it with
    ``pad_slots``)."""
    if "data" not in mesh_axes:
        raise ValueError("pool sharding needs a mesh with a 'data' axis")
    data = int(mesh_axes["data"])

    def stream(t: torch.Tensor, axis: int) -> int:
        if t.shape[axis] % data:
            raise ValueError(f"KV-pool stream axis of size {t.shape[axis]} does not divide the mesh data "
                             f"axis ({data}): pad n_slots with launch.sharding.pad_slots() instead of "
                             f"replicating a pool shard")
        return axis

    out: dict = {}
    for key, val in cache.items():
        if key == "attn":
            a = {"pos": stream(val["pos"], 0) if val["pos"].dim() == 2 else None,
                 "len": stream(val["len"], 0) if val["len"].dim() == 1 else None}
            if "block_tbl" in val:
                a["k"] = a["v"] = None
                a["block_tbl"] = stream(val["block_tbl"], 0)
            else:
                a["k"], a["v"] = stream(val["k"], 1), stream(val["v"], 1)
            out[key] = a
        elif key in ("rec_state", "rec_conv"):
            out[key] = stream(val, 2)
        elif key in ("state", "conv", "tail_state", "tail_conv", "cross_k", "cross_v"):
            out[key] = stream(val, 1)
        elif key == "len":
            out[key] = stream(val, 0) if val.dim() == 1 else None
        else:
            out[key] = None
    return out


def pool_local(mesh: DeviceMesh, cache: dict) -> dict:
    """This rank's part of a cache pool split over ``mesh`` as
    ``pool_shardings`` places it: the rows of its ``"data"`` index of every
    leaf with a stream axis (copies), every other leaf (a paged arena) as
    it is, on the cache's own device.  The mesh's device type says where
    its collectives run, not where the rows live: ranks that share one
    card exchange over a ``"cpu"`` (gloo) mesh."""
    axes = mesh_axes(mesh)
    specs = pool_specs(axes, cache)
    rank = mesh.get_local_rank("data")

    def part(tree, spec):
        if isinstance(tree, dict):
            return {k: part(v, spec[k]) for k, v in tree.items()}
        if spec is None:
            return tree
        b = tree.shape[spec] // axes["data"]
        return tree.narrow(spec, rank * b, b).clone()

    return part(cache, specs)


def pool_shardings(mesh, cache: dict) -> dict:
    """Place a cache pool.

    ``mesh`` a ``DeviceMesh`` (``launch.mesh.make_data_mesh``): every leaf
    becomes a DTensor whose stream axis is ``Shard`` on the ``"data"`` axis
    (``pool_specs``), replicated on the others, over this rank's part
    (``pool_local``): ONE pool split across the mesh's ranks, JAX's SPMD
    form.  ``cache`` must be the same on every rank, as the host arrays JAX
    commits are: the placement moves nothing between ranks.  ``mesh`` a
    ``torch.device`` (or a sequence of one): every leaf moved there, one
    shard's pool of the sharded engine.  A list of several devices in one
    process raises: one pool over several cards is served over a
    ``DeviceMesh`` of ranks, one a card (ROADMAP queue 1 item 8c's form,
    ``BatchedSpeculativeEngine(..., mesh=make_data_mesh(n))``)."""
    if isinstance(mesh, DeviceMesh):
        axes = mesh_axes(mesh)
        specs = pool_specs(axes, cache)

        def place(tree, spec):
            if isinstance(tree, dict):
                return {k: place(v, spec[k]) for k, v in tree.items()}
            pl = tuple(Shard(spec) if name == "data" and spec is not None else Replicate() for name in axes)
            return DTensor.from_local(tree, mesh, pl, run_check=False)

        return place(pool_local(mesh, cache), specs)
    devices = [mesh] if isinstance(mesh, (str, torch.device)) else list(mesh)
    if len(devices) != 1:
        raise NotImplementedError(
            f"one pool over {len(devices)} devices of one process is not served: split it over a DeviceMesh "
            f"of ranks, one a card (BatchedSpeculativeEngine(..., mesh=launch.mesh.make_data_mesh(n)), ROADMAP "
            f"queue 1 item 8c), or into slot shards with ShardedBatchedSpeculativeEngine, one a rank "
            f"(group=..., launch/serve.py --distributed)")
    dev = torch.device(devices[0])

    def move(tree: dict) -> dict:
        return {k: move(v) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    return move(cache)
